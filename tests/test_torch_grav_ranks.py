"""syncGrav on 8 ranks (cstone_tpu_torch.grav_ranks) on the CPU at 8 x
4,000 of its particles (normal(0, 0.25) clipped to +-0.99 in the open box
[-1, 1], masses uniform(0.5, 1.5), theta 0.4, bucket 64), against the
JAX package's 8-rank p2p syncGrav + update_expansion_centers inside
shard_map and its one-rank run, and against the float64 centre of mass of
every focus node.

The cold step of grav_steps on 8 run_ranks threads in p2p mode, and the
same step at one rank, by both packages. Tolerance:

- every rank's focus tree, assignment and buffer size equal to JAX's;
- grav_ranks.rank_checks passes on every rank: overflow 0, the owned
  ids a partition, the one-rank centres within rtol 1e-5 of the oracle,
  on the nodes inside a rank's assignment its centres and MAC spheres
  within rtol 1e-5 of the one-rank run's, elsewhere its centres within
  rtol plus grav_ranks.OUTSIDE_UNITS rounding units of the oracle (the
  bound the owners' float32 prefix sums put on them) and its MAC radii
  moved no more than their centres;
- the foreign leaves recomputed from plain float32 prefix sums land as
  far from the oracle as the rank's, within the limit; rounded to 16
  significant bits (the control) they land beyond it;
- JAX's ranks measured the same way: inside their assignment within rtol
  1e-5 of JAX's one-rank run, outside it farther than that on some node
  (its foreign leaves come from float32 prefix sums too) and within the
  same limit of the oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.parallel import make_mesh, rank_axis
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu_torch import grav_ranks as gr
from cstone_tpu_torch.multichip import rank_input, tree_capacity
from cstone_tpu_torch.ops.keys64 import ule
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.tree.octree import node_keys_and_levels

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

R, N_PER = 8, 4000
N = R * N_PER
CPU = torch.device("cpu")
TREE_CAP = tree_capacity(N, gr.BUCKET)
# at this size every rank holds every other particle as a halo
CAPS = {"local": N, "tree": TREE_CAP, "focus": TREE_CAP, "move": 0, "treelet": 0, "halo": 0}


def jax_runs(setup):
    """JAX's cold syncGrav + update_expansion_centers: on R ranks in p2p
    mode inside shard_map, from the ranks' inputs of grav_steps, and at one
    rank. Each a tuple of numpy arrays (per rank for the first): focus
    prefixes, node count, assignment boundaries, buffer size, centres, MAC
    spheres, overflow."""
    kw = dict(bucket_size=gr.BUCKET, theta=gr.THETA, key_dtype=jnp.uint64, tree_capacity=TREE_CAP,
              focus_capacity=TREE_CAP)
    jbox = jax_make_box(-1.0, 1.0)

    def run(d, x, y, z, h, m, n):
        state, res = d.sync(d.init_state(box=jbox), x, y, z, h, properties=(m,), n_local=n, grav=True)
        centers, spheres, _, ovf = d.update_expansion_centers(state, res, res.properties[0])
        return (res.tree.prefixes, res.tree.n_nodes, state.assignment.boundaries, res.n_with_halos, centers, spheres,
                jnp.maximum(res.overflow, ovf))

    def step(x, y, z, h, m, n):
        d = JaxDomain(rank=jax.lax.axis_index(rank_axis), n_ranks=R, axis_name=rank_axis, exchange_mode="p2p",
                      protocol="dense", **kw)
        return jax.tree.map(lambda a: jnp.asarray(a)[None], run(d, x, y, z, h, m, n[0]))

    inputs = [rank_input(setup, r, R, CAPS["local"]) for r in range(R)]
    cols = [np.concatenate([np.asarray(f(i)) for i in inputs]) for f in (
        lambda i: i["xyz"][0], lambda i: i["xyz"][1], lambda i: i["xyz"][2], lambda i: i["h"], lambda i: i["m"])]
    n_local = np.array([int(i["n"]) for i in inputs], np.int32)
    mesh = make_mesh(R)
    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=P(rank_axis), out_specs=P(rank_axis), check_vma=False))
    sharding = NamedSharding(mesh, P(rank_axis))
    ranks = fn(*(jax.device_put(jnp.asarray(c), sharding) for c in cols + [n_local]))
    one = jax.jit(lambda *a: run(JaxDomain(rank=0, n_ranks=1, **kw), *a))(
        *(jnp.asarray(np.asarray(c)) for c in (*setup["xyz"], setup["h"], setup["m"])), jnp.int32(N))
    return jax.tree.map(np.asarray, ranks), jax.tree.map(np.asarray, one)


@pytest.fixture(scope="module")
def runs():
    setup = gr.grav_setup(N, CPU)
    ref, _ = gr.grav_steps(None, setup, {"tree": TREE_CAP}, None, steps=0)
    outs = run_ranks(R, lambda comm: gr.grav_steps(comm, setup, CAPS, "p2p", steps=0))
    assert all(o[1] == CAPS for o in outs)
    return ref[0], [o[0][0] for o in outs], jax_runs(setup)


def test_rank_centres_match_one_rank_and_the_oracle(runs):
    ref, outs, _ = runs
    gr.one_rank_checks("one rank", ref)
    sums = gr.step_sums(ref)
    cmp = run_ranks(R, lambda comm, o: gr.rank_checks("p2p, cold step", comm, o, ref, sums), outs)
    for r, c in enumerate(cmp):
        assert c["shared"] == c["nodes"] and 0 < c["held"] < c["nodes"], r
        assert c["gap"] <= gr.CENTER_RTOL and max(c["pos"], c["mass"]) <= gr.OUTSIDE_UNITS and c["sphere"] == 0, r
    # the foreign leaves' float32 range sums: farther than rtol from the
    # one-rank centres, as far as plain float32 prefix sums put them, and
    # the control beyond the limit
    assert max(max(c["pos"], c["mass"]) for c in cmp) > 0
    readings = gr.prefix_sum_readings(outs, ref, sums)
    for c, x in zip(cmp, readings):
        assert max(x["float32"]) <= gr.OUTSIDE_UNITS < max(x["control"])
        assert 0.5 <= max(c["pos"], c["mass"]) / max(x["float32"]) <= 2.0


def test_jax_ranks_give_the_same_centres(runs):
    # JAX's own 8-rank centres: within rtol 1e-5 of its one-rank run inside
    # each rank's assignment, farther outside it, and within the outside
    # limit of the float64 oracle: the rule the port is held to
    ref, outs, ((jpre, jnn, jb, jnwh, jc, js, jovf), one) = runs
    res = ref["res"]
    assert int(one[1]) == int(res.tree.n_nodes)
    np.testing.assert_array_equal(one[0][:int(one[1])].view(np.int64), res.tree.prefixes[:int(one[1])].numpy())
    outside = []
    for r, o in enumerate(outs):
        t = o["res"].tree
        nn = int(t.n_nodes)
        assert int(jovf[r]) == 0 and int(jnn[r]) == nn, r
        np.testing.assert_array_equal(jpre[r][:nn].view(np.int64), t.prefixes[:nn].numpy(), err_msg=f"rank {r}")
        np.testing.assert_array_equal(jb[r].view(np.int64), o["state"].assignment.boundaries.numpy())
        assert int(jnwh[r]) == int(o["res"].n_with_halos), r
        # JAX's centres and spheres in the port's checks
        jax_rank = dict(o, centers=torch.from_numpy(np.array(jc[r])), spheres=torch.from_numpy(np.array(js[r])))
        jax_one = dict(ref, centers=torch.from_numpy(np.array(one[4])), spheres=torch.from_numpy(np.array(one[5])))
        c = gr.centers_vs_one_rank("JAX", r, jax_rank, jax_one)
        assert c["gap"] <= gr.CENTER_RTOL and max(c["pos"], c["mass"]) <= gr.OUTSIDE_UNITS, r

        start, end, level = (a[:nn] for a in node_keys_and_levels(t))
        b = o["state"].assignment.boundaries
        inside = ule(b[r], start) & ule(end, b[r + 1])
        side = gr._sides(o["state"].box, level)
        vs_one = gr.rel_gaps(jax_rank["centers"][:nn], jax_one["centers"][:nn], side).amax(dim=1)
        outside.append(float(vs_one[~inside].max()))
    assert max(outside) > gr.CENTER_RTOL
