"""The port's batched tree algebra (``repro_torch.core.tree``) against the
JAX package's single-request functions vmapped over the batch.

Seeded trajectories drive both sides with the same inputs (numpy draws,
with deliberate equal-weight ties) through seed, expansion, batch
selection, the async round's accept prediction, the greedy walk and the
re-root, and through the serving slot lifecycle (re-seed and park one
row); after every step each field of ``Tree``, ``BatchPlan``, ``MovePlan``
and ``FillPlan`` and of the prediction must be exactly equal, dtype
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.core import tree as JT
from repro_torch.core import tree as T

B, V, C, W = 3, 48, 2, 3


def _assert_same(jax_tuple, torch_tuple, what):
    jax_tuple = jax_tuple if isinstance(jax_tuple, tuple) else (jax_tuple,)
    torch_tuple = torch_tuple if isinstance(torch_tuple, tuple) else (torch_tuple,)
    names = getattr(torch_tuple, "_fields", range(len(torch_tuple)))
    assert len(jax_tuple) == len(torch_tuple), what
    for name, j, t in zip(names, jax_tuple, torch_tuple):
        j, t = np.asarray(j), t.numpy()
        assert j.dtype == t.dtype, f"{what}.{name}: {j.dtype} vs {t.dtype}"
        np.testing.assert_array_equal(t, j, err_msg=f"{what}.{name}")


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


class Pair:
    """One batch of trees advanced in lockstep on both sides."""

    def __init__(self, rng, n_cap, S_max, window, plen):
        self.rng, self.S_max, self.window = rng, S_max, window
        # seed_root takes a log-softmax, whose last bit differs between the two
        # frameworks (their exp differs).  One 0 per row and every other logit
        # low enough that its exp underflows make it exact on both sides; the
        # many equal low logits still tie in top_k.
        logits = -100.0 * rng.integers(2, 4, size=(B, V)).astype(np.float32)
        logits[np.arange(B), rng.integers(0, V, size=B)] = 0.0
        tok = rng.integers(0, V, size=(B,)).astype(np.int32)
        jt = jax.tree.map(lambda x: jnp.stack([x] * B), JT.init_tree(n_cap))
        t = T.init_tree(n_cap, B, "cpu")
        _assert_same(jt, t, "init_tree")
        self.jt = jax.vmap(lambda tr, k, lg: JT.seed_root(tr, k, plen, lg, C))(
            jt, jnp.asarray(tok), jnp.asarray(logits))
        self.t = T.seed_root(t, _t(tok), plen, _t(logits), C)
        _assert_same(self.jt, self.t, "seed_root")
        # the reference's functions, vmapped over the batch and jitted as the
        # engine runs them
        vm = lambda f: jax.jit(jax.vmap(f))  # noqa: E731
        self.j_select_leaves = vm(lambda tr: JT.select_leaves(tr, W))
        self.j_leaf_inputs = vm(lambda tr, i, v: JT.leaf_inputs(tr, i, v, S_max, window))
        self.j_insert_children = vm(JT.insert_children)
        self.j_ancestor_matrix = vm(JT.ancestor_matrix)
        self.j_verify_walk = vm(JT.verify_walk)
        self.j_predict = vm(JT.predict_accept)
        self.j_reroot = vm(JT.reroot)

    def expand(self):
        rng = self.rng
        jids, jvalid = self.j_select_leaves(self.jt)
        ids, valid = T.select_leaves(self.t, W)
        _assert_same((jids, jvalid), (ids, valid), "select_leaves")
        jin = self.j_leaf_inputs(self.jt, jids, jvalid)
        tin = T.leaf_inputs(self.t, ids, valid, self.S_max, self.window)
        _assert_same(jin, tin, "leaf_inputs")
        ct = rng.integers(0, V, size=(B, W, C)).astype(np.int32)
        cl = -np.sort(rng.choice([0.25, 0.5, 1.0], size=(B, W, C)), axis=-1).astype(np.float32)
        self.jt = self.j_insert_children(self.jt, jids, jvalid, jin[1], jnp.asarray(ct),
                                         jnp.asarray(cl))
        self.t = T.insert_children(self.t, ids, valid, tin[1], _t(ct), _t(cl))
        _assert_same(self.jt, self.t, "insert_children")
        _assert_same(self.j_ancestor_matrix(self.jt), T.ancestor_matrix(self.t),
                     "ancestor_matrix")

    def verify_and_reroot(self, bs):
        rng = self.rng
        jplan = jax.jit(jax.vmap(lambda tr: JT.select_batch(tr, bs, self.S_max, self.window)))(
            self.jt)
        plan = T.select_batch(self.t, bs, self.S_max, self.window)
        _assert_same(jplan, plan, "select_batch")
        _assert_same(self.j_predict(self.jt, jplan.node_ids, jplan.parent_pos, jplan.valid),
                     T.predict_accept(self.t, plan.node_ids, plan.parent_pos, plan.valid),
                     "predict_accept")
        # target argmax: mostly a child's token so that paths are accepted
        tok, par, val = (np.asarray(x) for x in (jplan.tokens, jplan.parent_pos, jplan.valid))
        argmax = rng.integers(0, V, size=(B, bs)).astype(np.int32)
        for b in range(B):
            for i in range(bs):
                kids = np.where((par[b] == i) & val[b])[0]
                if len(kids) and rng.random() < 0.8:
                    argmax[b, i] = tok[b, rng.choice(kids)]
        jw = self.j_verify_walk(jplan.tokens, jplan.parent_pos, jplan.valid,
                                jnp.asarray(argmax))
        w = T.verify_walk(plan.tokens, plan.parent_pos, plan.valid, _t(argmax))
        _assert_same(jw, w, "verify_walk")
        jr = self.j_reroot(self.jt, jplan.node_ids, jw[0], jw[1], jw[2])
        r = T.reroot(self.t, plan.node_ids, w[0], w[1], w[2])
        for name, jx, x in zip(("Tree", "MovePlan", "FillPlan"), jr, r):
            _assert_same(jx, x, f"reroot {name}")
        self.jt, self.t = jr[0], r[0]
        return int(np.asarray(jw[1]).sum())


@pytest.mark.parametrize("seed,n_cap,S_max,window", [
    (0, 32, 128, 0),
    (1, 16, 128, 0),  # small capacity: children beyond it drop
    (2, 32, 64, 6),   # sliding window on the prefix rows
    (3, 24, 40, 0),   # small cache: leaf rows overflow and are skipped
])
def test_trajectory_matches_reference(seed, n_cap, S_max, window):
    pair = Pair(np.random.default_rng(seed), n_cap, S_max, window, plen=10)
    accepted = 0
    for _ in range(4):
        pair.expand()
        pair.expand()
        accepted += pair.verify_and_reroot(bs=6)
    assert accepted > 0, "the trajectory must exercise accepted paths"


def test_slot_lifecycle_matches_reference():
    """Park and re-seed single rows of a batch in the middle of a
    trajectory: ``reset_slot`` and ``seed_slot`` equal the reference's on
    every field, the other rows stay as they were, and the batch runs on."""
    rng = np.random.default_rng(5)
    pair = Pair(rng, 24, 96, 0, plen=7)
    pair.expand()
    pair.verify_and_reroot(bs=5)
    j_reset = jax.jit(JT.reset_slot)
    j_seed = jax.jit(lambda tr, s, tok, pl, lg: JT.seed_slot(tr, s, tok, pl, lg, C))
    for slot, plen in ((1, 12), (0, 5), (2, 9)):
        before = pair.t
        pair.jt, pair.t = j_reset(pair.jt, slot), T.reset_slot(pair.t, slot)
        _assert_same(pair.jt, pair.t, f"reset_slot {slot}")
        assert not pair.t.valid[slot].any()
        others = [b for b in range(B) if b != slot]
        for f, g in zip(before, pair.t):
            assert torch.equal(f[others], g[others]), "reset_slot touched another row"
        logits = -100.0 * rng.integers(2, 4, size=(V,)).astype(np.float32)
        logits[rng.integers(0, V)] = 0.0
        tok = int(rng.integers(0, V))
        pair.jt = j_seed(pair.jt, slot, jnp.asarray(tok, jnp.int32), jnp.asarray(plen, jnp.int32),
                         jnp.asarray(logits))
        pair.t = T.seed_slot(pair.t, slot, tok, plen, _t(logits), C)
        _assert_same(pair.jt, pair.t, f"seed_slot {slot}")
        pair.expand()
        pair.verify_and_reroot(bs=5)


def test_predict_accept_walks_the_top_chain():
    """On a chain plan the prediction follows the first child of each node
    and the bonus is the last node's top child; with no child it is -1."""
    t = T.seed_root(T.init_tree(8, 1, "cpu"), torch.tensor([3], dtype=torch.int32), 4,
                    _t(np.array([[0.0] + [-200.0] * (V - 1)], np.float32)), C)
    plan = T.select_batch(t, 4, 32)
    acc, n_acc, bonus = T.predict_accept(t, plan.node_ids, plan.parent_pos, plan.valid)
    assert n_acc.tolist() == [1] and acc[0, 0] == 1  # the root's top child, plan slot 1
    assert bonus.tolist() == [-1]  # node 1 has no child in the tree


def test_top_k_breaks_ties_like_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(5, 40)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 7)
    v, i = T.top_k(_t(x), 7)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_select_leaves_pads_short_sets_and_gates_the_root():
    """A fresh tree has 2 unexpanded nodes: the third pick is padding, its
    id must not claim the root's prefix row."""
    logits = np.zeros((B, V), np.float32)
    jt = jax.vmap(lambda tr, lg: JT.seed_root(tr, 1, 5, lg, C))(
        jax.tree.map(lambda x: jnp.stack([x] * B), JT.init_tree(16)), jnp.asarray(logits))
    t = T.seed_root(T.init_tree(16, B, "cpu"), torch.ones(B, dtype=torch.int32), 5,
                    _t(logits), C)
    jids, jvalid = jax.vmap(lambda tr: JT.select_leaves(tr, W))(jt)
    ids, valid = T.select_leaves(t, W)
    _assert_same((jids, jvalid), (ids, valid), "select_leaves")
    assert not valid[:, 2].any()
    _, rows, _, mask, _ = T.leaf_inputs(t, ids, valid, 32)
    assert (rows[:, 2] == -1).all() and not mask[:, 2].any()
    _assert_same(jax.vmap(lambda tr, i, v: JT.leaf_inputs(tr, i, v, 32))(jt, jids, jvalid),
                 T.leaf_inputs(t, ids, valid, 32), "leaf_inputs")
