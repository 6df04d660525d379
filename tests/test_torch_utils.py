"""Checkpoints, the Timer and tree flattening of the PyTorch port
(utils/), after tests/test_utils.py.

Tolerance: none; restored leaves are bit-equal and keep their dtypes,
devices and host flags."""

import dataclasses

import numpy as np
import pytest
import torch

from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.sfc import PERIODIC, make_box
from cstone_tpu_torch.utils import Timer, load_checkpoint, save_checkpoint
from cstone_tpu_torch.utils.tree import tree_leaves, tree_unflatten

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


def test_checkpoint_roundtrip_domain_state(tmp_path):
    domain = Domain(bucket_size=16, tree_capacity=256, device="cpu")
    state = domain.init_state()
    p = tmp_path / "ckpt.pt"
    save_checkpoint(p, state)
    restored = load_checkpoint(p, state)
    assert torch.equal(restored.global_tree.keys, state.global_tree.keys)
    assert torch.equal(restored.box.limits, state.box.limits)
    assert restored.box.boundaries == state.box.boundaries
    assert restored.first_call is True and restored.focus_converged is False
    assert restored.linked.child_offsets.dtype == torch.int64


def test_checkpoint_restores_synced_state_values(tmp_path):
    """A synced state's values come back, host flags included, into a
    `like` of the same structure whose values differ."""
    rng = np.random.RandomState(1)
    pos = torch.from_numpy(rng.uniform(0, 1, (500, 3)).astype(np.float32))
    h = torch.full((500,), 0.05)
    domain = Domain(bucket_size=16, tree_capacity=256, device="cpu")
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    fresh = domain.init_state(box=box, boundaries=box.boundaries)
    synced, _ = domain.sync(fresh, pos[:, 0], pos[:, 1], pos[:, 2], h)
    save_checkpoint(tmp_path / "s.pt", {"state": synced, "h": h, "step": 7, "name": "run"})
    out = load_checkpoint(tmp_path / "s.pt", {"state": fresh, "h": torch.zeros(500), "step": 0, "name": ""})
    assert out["step"] == 7 and out["name"] == "run" and torch.equal(out["h"], h)
    assert out["state"].first_call is False
    for a, b in zip(tree_leaves(out["state"]), tree_leaves(synced)):
        assert (torch.equal(a, b) and a.dtype == b.dtype) if isinstance(b, torch.Tensor) else a == b


def test_checkpoint_rejects_other_files_and_shapes(tmp_path):
    torch.save({"a": torch.zeros(3)}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="not a checkpoint"):
        load_checkpoint(tmp_path / "other.pt", {"a": torch.zeros(3)})
    save_checkpoint(tmp_path / "two.pt", (torch.zeros(2), torch.ones(2)))
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(tmp_path / "two.pt", (torch.zeros(2),))


@dataclasses.dataclass(frozen=True)
class _Pair:
    a: torch.Tensor
    b: tuple


def test_tree_flatten_roundtrip():
    tree = {"p": _Pair(torch.arange(3), (1, torch.ones(2), [None, "s"])), "q": 2.5}
    leaves = tree_leaves(tree)
    assert len(leaves) == 6 and leaves[-1] == 2.5
    again = tree_unflatten(tree, [x * 2 if isinstance(x, torch.Tensor) else x for x in leaves])
    assert isinstance(again["p"], _Pair) and isinstance(again["p"].b, tuple) and isinstance(again["p"].b[2], list)
    assert torch.equal(again["p"].a, torch.arange(3) * 2) and again["p"].b[0] == 1


def test_timer():
    t = Timer()
    out = t.stage("add", lambda a: a + 1, torch.arange(10))
    assert torch.equal(out, torch.arange(1, 11))
    t.stage("add", lambda a: (a, {"b": a * 2}), torch.arange(4))
    t.stage("none", lambda: None)
    assert set(t.times) == {"add", "none"} and t.times["add"] >= 0
    report = t.report()
    assert "add:" in report and "total" in report
