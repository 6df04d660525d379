"""syncGrav (Domain.sync(grav=True), domain.hpp:246-325) on several
thread ranks of one process, held to the one-rank run of the same
particles and to the float64 centre of mass of every focus node.

The particles (`grav_setup`): n positions normal(0, 0.25) clipped to
+-0.99 in the open box [-1, 1], masses uniform(0.5, 1.5), h = 0.012,
from RandomState(42); then a drift of uniform(-0.2, 0.2) x the mean
spacing 2 n^(-1/3), drawn after them. `grav_steps` runs one rank's cold
syncGrav under sync_with_retry and a number of drift steps, each followed
by update_expansion_centers; with comm None it is the one-rank reference.
`grav_ranks_checks` holds a step of every rank:

- overflow 0, of the sync and of the centres' range-sum service;
- the owned particle ids a partition of the particles;
- the one-rank run's centres within CENTER_RTOL of the float64 oracle
  (`oracle_centers`) on every node;
- on the focus nodes whose key range lies in the rank's own assignment,
  the rank's centres and MAC spheres within CENTER_RTOL of the one-rank
  run's. These are summed from the rank's own particles, as at one rank;
- on every other node, the centres within rtol plus OUTSIDE_UNITS
  rounding units of the float64 oracle (`rounding_units`). A foreign
  leaf's sums are differences of the owner's float32 prefix sums
  (range_sum_service, as in the JAX package): each is off by up to about
  eps32 x the owner's prefix sum of |values| at the leaf's two ends, a
  bound that grows with the owner's particle count, and a node's bound is
  the sum of its leaves'. Their MAC radii move from the one-rank run's by
  no more than their centres do (the radius is the node's reach plus the
  centre's distance from the node's middle);
- `prefix_sum_readings` recomputes the foreign leaves' centres from
  plain prefix sums of the owners' particles, in float32 (what the range
  sums do) and rounded to CONTROL_BITS significant bits (a control that
  the limits must refuse);
- with the pool run given, every rank of a p2p run equal slot for slot to
  the pool run's: assignment, focus leaves, buffer size, keys, layout and
  the halo flags over the leaves.

Gaps within rtol: positions relative to the larger of the reference's
value and the node's side, masses and squared MAC radii relative to the
reference's."""

from __future__ import annotations

import time

import numpy as np
import torch

SEED = 42
H = 0.012
BUCKET = 64
THETA = 0.4
CENTER_RTOL = 1e-5
OUTSIDE_UNITS = 16.0
CONTROL_BITS = 16


def _check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"syncGrav on ranks: {msg}")


def grav_setup(n: int, device, h: float = H, seed: int = SEED) -> dict:
    """The particles of the module docstring on `device`, in
    multichip.rank_input's form (xyz, h, m, ids) with n, the drift and the
    box."""
    from .sfc import make_box

    rng = np.random.RandomState(seed)
    pos = rng.normal(0, 0.25, size=(n, 3)).clip(-0.99, 0.99).astype(np.float32)
    m = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    drift = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32) * np.float32(2.0 / n ** (1.0 / 3.0))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"n": n, "xyz": tuple(t(pos[:, i]) for i in range(3)), "m": t(m), "drift": t(drift),
            "h": torch.full((n,), h, dtype=torch.float32, device=device), "ids": torch.arange(n, device=device),
            "box": make_box(-1.0, 1.0, device=device)}


def grav_drift(inp: dict, drift: torch.Tensor, sgn: float) -> dict:
    """A rank's next input: its particles moved by sgn x the drift of their ids."""
    return dict(inp, xyz=tuple(c + sgn * drift[inp["ids"].clamp(min=0), i] for i, c in enumerate(inp["xyz"])))


def grav_sync(comm, domain, state, inp: dict):
    """One syncGrav between two barriers (comm None: one rank): (state,
    res, (start, end)) on the host clock, the stream drained."""
    if comm is not None:
        comm.all_reduce_flag(True)  # start together
    t0 = time.perf_counter()
    state, res = domain.sync(state, *inp["xyz"], inp["h"], properties=(inp["m"],), n_local=inp["n"], grav=True)
    if res.x.device.type == "cuda":
        torch.cuda.current_stream(res.x.device).synchronize()
    return state, res, (t0, time.perf_counter())


def grav_steps(comm, setup: dict, caps0: dict, mode, steps: int, bucket: int = BUCKET, theta: float = THETA):
    """One rank (comm None: the one-rank reference, all particles): a cold
    syncGrav under sync_with_retry from caps0, then `steps` drift steps
    fed by compact_owned, each sync followed by update_expansion_centers.
    Returns (per step a dict of the state, result, centres, MAC spheres,
    their overflow, the span, the comm's rounds and bytes and the particle
    ids of the slots; the capacities)."""
    from . import multichip
    from .domain import Domain, sync_with_retry

    dev = setup["ids"].device
    tally = None if comm is None else multichip.RankTally.of(comm)

    def cold(caps):
        if comm is None:
            domain = Domain(bucket_size=bucket, theta=theta, tree_capacity=caps["tree"], device=dev)
            inp = {k: setup[k] for k in ("xyz", "h", "m", "ids")} | {"n": setup["n"]}
        else:
            tally.reset()
            domain = multichip.make_domain(comm, caps, mode, "dense", dev, 0, bucket, theta)
            inp = multichip.rank_input(setup, comm.rank, comm.n_ranks, caps["local"])
        state, res, span = grav_sync(comm, domain, domain.init_state(box=setup["box"]), inp)
        return domain, inp, state, span, res

    (domain, inp, state, span, res), caps = sync_with_retry(cold, caps0)
    out, sgn = [], 1.0
    for step in range(1 + steps):
        if step:
            if tally is not None:
                tally.reset()
            state, res, span = grav_sync(comm, domain, state, inp)
        stats = None if tally is None else tally.read()
        centers, spheres, _, c_ovf = domain.update_expansion_centers(state, res, res.properties[0])
        rid = domain.reapply_sync(res, inp["ids"])
        out.append({"state": state, "res": res, "centers": centers, "spheres": spheres, "c_ovf": int(c_ovf),
                    "span": span, "stats": stats, "rid": rid})
        if step == steps:
            break
        co = domain.compact_owned
        nxt = {"xyz": tuple(co(res, c) for c in (res.x, res.y, res.z)), "h": co(res, res.h),
               "m": co(res, res.properties[0]), "ids": co(res, rid), "n": res.end_index - res.start_index}
        inp = grav_drift(nxt, setup["drift"], sgn)
        sgn = -sgn
    return out, caps


def _node_ranges(tree, nn):
    from .tree.octree import node_keys_and_levels

    return tuple(a[:nn] for a in node_keys_and_levels(tree))


def _sides(box, level) -> torch.Tensor:
    lim = box.limits.double()
    return (lim[1::2] - lim[0::2])[None, :] / torch.pow(2.0, level.double())[:, None]


def _prefix64(v: torch.Tensor) -> torch.Tensor:
    """(n + 1, 4) float64 prefix sums of (n, 4) values, a leading zero row;
    each column scanned as a contiguous row."""
    v = v.double()
    return torch.cat([v.new_zeros(1, 4), torch.cumsum(v.t().contiguous(), 1).t()])


def step_sums(ref: dict) -> dict:
    """What every rank's checks at one step share: the one-rank run's
    sorted keys, its float32 values w x, w y, w z, w (w = |m|, as the
    Domain sums them) and the float64 prefix sums of the values ("scan")
    and of their absolute values ("acc")."""
    res = ref["res"]
    n = int(res.end_index)
    w = res.properties[0][:n].abs()
    vals = torch.stack([w * res.x[:n], w * res.y[:n], w * res.z[:n], w], dim=-1)
    return {"keys": res.keys[:n], "vals": vals, "scan": _prefix64(vals), "acc": _prefix64(vals.abs())}


def _centers_of_sums(sums: torch.Tensor) -> torch.Tensor:
    mass = sums[:, 3:]
    return torch.cat([sums[:, :3] / torch.where(mass != 0, mass, 1.0), mass], dim=1)


def oracle_centers(sums: dict, start, end) -> torch.Tensor:
    """(len(start), 4) float64 centre of mass (x, y, z, mass) of every key
    range [start, end) over the particles of a step (step_sums):
    differences of float64 prefix sums."""
    from .ops.primitives import searchsorted

    scan = sums["scan"]
    return _centers_of_sums(scan[searchsorted(sums["keys"], end)] - scan[searchsorted(sums["keys"], start)])


def rel_gaps(got: torch.Tensor, want: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """(n, 2) gaps of (x, y, z, last) rows: the largest position gap
    relative to the larger of |want| and the node's side, and the last
    column's gap relative to |want|."""
    got, want = got.double(), want.double()
    d = (got - want).abs()
    pos = torch.where(d[:, :3] == 0, 0.0, d[:, :3] / torch.maximum(want[:, :3].abs(), side)).amax(dim=1)
    last = torch.where(d[:, 3] == 0, 0.0, d[:, 3] / want[:, 3].abs())
    return torch.stack([pos, last], dim=1)


def rounding_units(got: torch.Tensor, want: torch.Tensor, err: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """(n, 2) gaps of centres (x, y, z, mass) to the float64 `want` beyond
    CENTER_RTOL (positions: of the larger of |want| and the node's side; mass: of
    |want|), in units of the rounding bound that `err`, the bound on the
    error of each of the four sums, puts on them: (err_xyz + |want_xyz|
    err_m) / mass for positions, err_m for the mass. A gap at a node
    without mass or bound is infinite."""
    got, want, err = got.double(), want.double(), err.double()
    d = (got - want).abs()
    m = want[:, 3:].abs()
    over = torch.cat([(d[:, :3] - CENTER_RTOL * torch.maximum(want[:, :3].abs(), side)).clamp(min=0),
                      (d[:, 3:] - CENTER_RTOL * m).clamp(min=0)], dim=1)
    bound = torch.cat([(err[:, :3] + want[:, :3].abs() * err[:, 3:]) / torch.where(m > 0, m, 1.0), err[:, 3:]],
                      dim=1)
    units = torch.where(over == 0, 0.0, over / torch.where(bound > 0, bound, 0.0))
    return torch.stack([units[:, :3].amax(dim=1), units[:, 3]], dim=1)


def one_rank_checks(what, ref) -> float:
    """The one-rank run's centres against the float64 oracle on every
    node: within CENTER_RTOL. Returns the largest gap."""
    res = ref["res"]
    nn = int(res.tree.n_nodes)
    start, end, level = _node_ranges(res.tree, nn)
    gap = float(rel_gaps(ref["centers"][:nn], oracle_centers(step_sums(ref), start, end),
                         _sides(ref["state"].box, level)).max())
    _check(gap <= CENTER_RTOL,
           f"{what}: the one-rank centres differ from the float64 oracle by {gap:.3e} > {CENTER_RTOL}")
    return gap


def _leaf_sums(got: dict, sums: dict, rank: int) -> dict:
    """What a rank's foreign leaf sums are made of: the leaves [a, b) of
    its focus tree, their owners, their first particles and the owners'
    in the step's sorted particles (lo, hi, seg), and per leaf the bound
    on the float32 rounding of its four sums, in float64: for a foreign
    leaf eps32 x (A(lo) + A(hi)), A the owner's prefix sum of |values|
    (the rounding of the two prefix sums the range sum differences), for
    an own leaf eps32 x its sum of |values|."""
    from .ops.primitives import searchsorted

    t = got["res"].tree
    nl = int(t.n_leaf)
    a, b = t.leaves[:nl], t.leaves[1:nl + 1]
    bounds = got["state"].assignment.boundaries
    owner = torch.clamp(searchsorted(bounds, a, side="right") - 1, 0, bounds.shape[0] - 2)
    keys, acc = sums["keys"], sums["acc"]
    lo, hi, seg = searchsorted(keys, a), searchsorted(keys, b), searchsorted(keys, bounds)
    base = acc[seg[owner]]
    eps = float(torch.finfo(torch.float32).eps)
    foreign = owner != rank
    err = eps * torch.where(foreign[:, None], acc[lo] - base + acc[hi] - base, acc[hi] - acc[lo])
    return {"nl": nl, "a": a, "b": b, "owner": owner, "foreign": foreign, "lo": lo, "hi": hi, "seg": seg,
            "err": err}


def centers_vs_one_rank(what, rank: int, got: dict, ref: dict, sums: dict | None = None) -> dict:
    """A rank's expansion centres and MAC spheres (`got`, a grav_steps
    step) against the one-rank run's (`ref`) and the float64 oracle, as
    the module docstring says (`sums`: step_sums(ref), computed here if
    None). Returns the readings: focus nodes, those shared with the
    one-rank tree, those held to CENTER_RTOL and the largest gap there;
    outside the rank's range the largest position and mass gaps to the
    oracle in rounding units (rounding_units) and the largest MAC radius
    gap beyond its centre's gap, relative to the radius."""
    from .ops.keys64 import ule, usort
    from .ops.primitives import searchsorted

    sums = step_sums(ref) if sums is None else sums
    t, rt = got["res"].tree, ref["res"].tree
    nn, rn = int(t.n_nodes), int(rt.n_nodes)
    pre = t.prefixes[:nn]
    rsorted, rorder = usort(rt.prefixes[:rn])
    pos = torch.clamp(searchsorted(rsorted, pre), max=rn - 1)
    hit = rsorted[pos] == pre
    j = rorder[pos]
    start, end, level = _node_ranges(t, nn)
    b = got["state"].assignment.boundaries
    inside = ule(b[rank], start) & ule(end, b[rank + 1])
    side = _sides(got["state"].box, level)

    one = torch.maximum(rel_gaps(got["centers"][:nn], ref["centers"][j], side),
                        rel_gaps(got["spheres"][:nn], ref["spheres"][j], side)).amax(dim=1)
    held = hit & inside
    out = {"nodes": nn, "shared": int(hit.sum()), "held": int(held.sum()),
           "gap": float(one[held].max()) if bool(held.any()) else 0.0}
    _check(out["gap"] <= CENTER_RTOL, f"{what}, rank {rank}: centres or MAC spheres of its own nodes differ from the "
                               f"one-rank run's by {out['gap']:.3e} > {CENTER_RTOL}")

    far = ~inside
    leaf = _leaf_sums(got, sums, rank)
    cerr = _prefix64(leaf["err"])
    leaves = t.leaves[:leaf["nl"] + 1]
    err = cerr[searchsorted(leaves, end)] - cerr[searchsorted(leaves, start)]
    units = rounding_units(got["centers"][:nn], oracle_centers(sums, start, end), err, side)[far]
    # the vector-MAC radius is the node's reach plus the distance of its
    # centre from the node's middle: it moves at most as far as the centre
    g, w = got["spheres"][:nn][hit & far].double(), ref["spheres"][j][hit & far].double()
    shift = torch.linalg.vector_norm(g[:, :3] - w[:, :3], dim=1)
    r = w[:, 3].sqrt()
    over = ((g[:, 3].sqrt() - r).abs() - shift - CENTER_RTOL * r).clamp(min=0) / torch.where(r > 0, r, 1.0)
    out["pos"] = float(units[:, 0].max()) if units.numel() else 0.0
    out["mass"] = float(units[:, 1].max()) if units.numel() else 0.0
    out["sphere"] = float(over.max()) if over.numel() else 0.0
    _check(out["pos"] <= OUTSIDE_UNITS and out["mass"] <= OUTSIDE_UNITS,
           f"{what}, rank {rank}: outside its range the centres are {out['pos']:.3e} (positions) and "
           f"{out['mass']:.3e} (mass) rounding units off the float64 oracle, above {OUTSIDE_UNITS}")
    _check(out["sphere"] == 0, f"{what}, rank {rank}: outside its range a MAC radius moved "
                               f"{out['sphere']:.3e} of itself more than its centre")
    return out


def _round_bits(a: torch.Tensor, bits: int) -> torch.Tensor:
    mant, expo = torch.frexp(a)
    return torch.ldexp(torch.round(mant * 2.0 ** bits) / 2.0 ** bits, expo.to(a.dtype))


def prefix_sum_readings(outs: list, ref: dict, sums: dict | None = None) -> list:
    """Every rank's foreign leaves summed as the range sums sum them, from
    differences of each owner's prefix sums over its own particles (the
    step's sorted particles cut at the ranks' assignment): in float32, as
    range_sum_service scans them, and in float64 rounded to CONTROL_BITS
    significant bits. Returns per rank, for each, the largest position and
    mass gaps of the leaf centres to the float64 oracle in rounding units
    (rounding_units)."""
    from .ops.primitives import searchsorted

    sums = step_sums(ref) if sums is None else sums
    bounds = outs[0]["state"].assignment.boundaries
    _check(all(torch.equal(o["state"].assignment.boundaries, bounds) for o in outs),
           "the ranks hold different assignments")
    seg = searchsorted(sums["keys"], bounds).tolist()
    scans = {}
    for name, dt, bits in (("float32", torch.float32, None), ("control", torch.float64, CONTROL_BITS)):
        per_owner = []
        for s0, s1 in zip(seg[:-1], seg[1:]):
            scan = torch.cat([sums["vals"].new_zeros(1, 4, dtype=dt), torch.cumsum(sums["vals"][s0:s1].to(dt), 0)])
            per_owner.append(scan if bits is None else _round_bits(scan, bits))
        scans[name] = per_owner
    out = []
    for rank, got in enumerate(outs):
        leaf = _leaf_sums(got, sums, rank)
        nl, owner, foreign = leaf["nl"], leaf["owner"], leaf["foreign"]
        t = got["res"].tree
        level = _node_ranges(t, int(t.n_nodes))[2][t.leaf_order()[:nl]]
        side = _sides(got["state"].box, level)[foreign]
        oracle = oracle_centers(sums, leaf["a"], leaf["b"])[foreign]
        reading = {}
        for name, per_owner in scans.items():
            got_sums = torch.zeros(nl, 4, dtype=per_owner[0].dtype, device=owner.device)
            for q, scan in enumerate(per_owner):
                mine = owner == q
                k = scan.shape[0] - 1
                got_sums[mine] = (scan[(leaf["hi"][mine] - seg[q]).clamp(0, k)]
                                  - scan[(leaf["lo"][mine] - seg[q]).clamp(0, k)])
            u = rounding_units(_centers_of_sums(got_sums[foreign]), oracle, leaf["err"][foreign], side)
            reading[name] = (float(u[:, 0].max()), float(u[:, 1].max())) if u.numel() else (0.0, 0.0)
        out.append(reading)
    return out


def grav_ranks_checks(what, outs, ref, pool_outs=None) -> list:
    """A step of every rank held as the module docstring says. Returns the
    per-rank centre readings (centers_vs_one_rank)."""
    n = ref["rid"].shape[0]
    owned = []
    for r, o in enumerate(outs):
        res = o["res"]
        _check(int(res.overflow) == 0 and o["c_ovf"] == 0,
               f"{what}, rank {r}: overflow {res.overflow_detail.tolist()}, centres {o['c_ovf']}")
        owned.append(o["rid"][int(res.start_index):int(res.end_index)])
    ids = torch.cat(owned)
    _check(ids.numel() == n and torch.equal(torch.sort(ids).values, torch.arange(n, device=ids.device)),
           f"{what}: the owned ranges are not a partition of the {n} particles")
    sums = step_sums(ref)
    cmp = [centers_vs_one_rank(what, r, o, ref, sums) for r, o in enumerate(outs)]
    if pool_outs is not None:
        for r, (p, o) in enumerate(zip(pool_outs, outs)):
            a, b = p["res"], o["res"]
            nl, nwh = int(a.tree.n_leaf), int(a.n_with_halos)
            same = (torch.equal(p["state"].assignment.boundaries, o["state"].assignment.boundaries)
                    and nl == int(b.tree.n_leaf) and nwh == int(b.n_with_halos)
                    and torch.equal(a.tree.leaves[:nl + 1], b.tree.leaves[:nl + 1])
                    and torch.equal(a.layout, b.layout) and torch.equal(a.halo_flags[:nl], b.halo_flags[:nl])
                    and torch.equal(a.keys[:nwh], b.keys[:nwh]))
            _check(same, f"{what}, rank {r}: p2p differs from pool (assignment, focus leaves, layout, halo flags "
                         f"over the leaves or keys)")
    return cmp
