"""The draft tree (``repro.core.tree``), written batched over ``[B, ...]``.

The reference writes each function for one request and vmaps it; here every
leaf carries the batch axis first and every function works on the whole
batch at once.  Layout and node invariants are the reference's: cache rows
[0, plen) hold the prefix with the root's token at row plen-1, rows
[plen, ...) hold tree-node KV; node 0 is the root; ``weight`` is the
cumulative log-prob from the root.

Port rules that keep plans equal to the reference's, field for field:

  * shapes never depend on data — no host sync, no boolean-mask indexing;
  * ``top_k`` is a stable descending sort, so ties go to the lowest index
    as ``jax.lax.top_k`` does; argsorts are stable; ``argmax`` takes the
    first maximum;
  * plans stay int32 (indices are widened to int64 only where torch
    indexes with them);
  * a masked-off scatter lands in a spare column that is cut off — never
    at index -1, which torch would read as the last element.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1e30


class Tree(NamedTuple):
    tokens: torch.Tensor  # i32[B, N]
    parent: torch.Tensor  # i32[B, N], -1 for root
    logp: torch.Tensor  # f32[B, N]
    weight: torch.Tensor  # f32[B, N] cum logp from root
    depth: torch.Tensor  # i32[B, N], root=0
    valid: torch.Tensor  # bool[B, N]
    expanded: torch.Tensor  # bool[B, N]
    kv_row: torch.Tensor  # i32[B, N] absolute cache row of node KV (-1 missing)
    n_nodes: torch.Tensor  # i32[B]
    plen: torch.Tensor  # i32[B], prefix length (root token at row plen-1)
    next_row: torch.Tensor  # i32[B], next free tree-cache row


class BatchPlan(NamedTuple):
    """Inputs for one target verification forward (paper Alg. 1 line 12)."""

    node_ids: torch.Tensor  # i32[B, bs] tree node per batch slot (slot 0 = root)
    tokens: torch.Tensor  # i32[B, bs]
    rows: torch.Tensor  # i32[B, bs] target cache rows (plen-1 + slot)
    positions: torch.Tensor  # i32[B, bs] rope positions
    mask: torch.Tensor  # bool[B, bs, S_max] target attention mask
    parent_pos: torch.Tensor  # i32[B, bs] batch slot of parent (-1 for root)
    valid: torch.Tensor  # bool[B, bs]


class MovePlan(NamedTuple):
    """KV row moves for re-root compaction (applied by core/kv.py)."""

    src: torch.Tensor  # i32[B, M]
    dst: torch.Tensor  # i32[B, M]
    mask: torch.Tensor  # bool[B, M]


class FillPlan(NamedTuple):
    """Accepted-but-never-expanded tokens whose prefix KV must be computed."""

    tokens: torch.Tensor  # i32[B, F]
    rows: torch.Tensor  # i32[B, F]
    positions: torch.Tensor  # i32[B, F]
    mask: torch.Tensor  # bool[B, F]


# -----------------------------------------------------------------------------
# helpers
# -----------------------------------------------------------------------------


def _i32(x):
    return x.to(torch.int32)


def _ar(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def _take(a, idx):
    """a [B, N] gathered at idx [B, k] (idx must be in range)."""
    return a.gather(1, idx.long())


def _scatter(arr, idx, val, mask):
    """Per batch row ``arr.at[where(mask, idx, N)].set(val, mode="drop")``."""
    B, N = arr.shape
    buf = torch.cat([arr, arr.new_zeros(B, 1)], dim=1)
    buf.scatter_(1, torch.where(mask, idx.long(), N), val.to(arr.dtype))
    return buf[:, :N]


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lowest index.  Returns (values, int32 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], _i32(idx[..., :k])


def _first_true(b):
    """argmax of a bool tensor over its last axis: the first True (0 if none)."""
    return _i32(b.to(torch.int32).argmax(-1))


# -----------------------------------------------------------------------------
# construction
# -----------------------------------------------------------------------------


def init_tree(n_cap: int, B: int, device) -> Tree:
    def full(val, dtype):
        return torch.full((B, n_cap), val, dtype=dtype, device=device)

    z = torch.zeros(B, dtype=torch.int32, device=device)
    return Tree(
        tokens=full(0, torch.int32),
        parent=full(-1, torch.int32),
        logp=full(0.0, torch.float32),
        weight=full(NEG, torch.float32),
        depth=full(0, torch.int32),
        valid=full(False, torch.bool),
        expanded=full(False, torch.bool),
        kv_row=full(-1, torch.int32),
        n_nodes=z,
        plen=z.clone(),
        next_row=z.clone(),
    )


def seed_root(tree: Tree, token, plen, root_logits, c: int) -> Tree:
    """Root = last verified token (KV at row plen-1, produced by prefill);
    children proposed from the prefill logits — root starts expanded.
    token [B]; plen int or [B]; root_logits [B, V]."""
    B, N = tree.tokens.shape
    dev = tree.tokens.device
    assert 1 + c <= N, (c, N)
    lp = torch.log_softmax(root_logits.float(), dim=-1)
    top_lp, top_tok = top_k(lp, c)
    plen = _i32(torch.as_tensor(plen, device=dev).expand(B))
    t = {f: getattr(tree, f).clone() for f in Tree._fields[:8]}
    t["tokens"][:, 0] = _i32(torch.as_tensor(token, device=dev))
    t["parent"][:, 0] = -1
    t["logp"][:, 0] = 0.0
    t["weight"][:, 0] = 0.0
    t["depth"][:, 0] = 0
    t["valid"][:, 0] = True
    t["expanded"][:, 0] = True
    t["kv_row"][:, 0] = plen - 1
    t["tokens"][:, 1:1 + c] = top_tok
    t["parent"][:, 1:1 + c] = 0
    t["logp"][:, 1:1 + c] = top_lp
    t["weight"][:, 1:1 + c] = top_lp
    t["depth"][:, 1:1 + c] = 1
    t["valid"][:, 1:1 + c] = True
    t["expanded"][:, 1:1 + c] = False
    t["kv_row"][:, 1:1 + c] = -1
    full = torch.full((B,), 1 + c, dtype=torch.int32, device=dev)
    return Tree(**t, n_nodes=full, plen=plen.clone(), next_row=plen.clone())


# -----------------------------------------------------------------------------
# per-slot lifecycle (continuous batching)
# -----------------------------------------------------------------------------
# Admission and retirement rewrite exactly one batch row of the tree and
# leave the other rows as they were.  ``slot`` is a host int; ``token`` and
# ``plen`` may be host ints or device scalars — a host int becomes a filled
# tensor, never a copy from the host, so no host sync is made.


def _row_scalar(x, device):
    if isinstance(x, torch.Tensor):
        return _i32(x.reshape(1))
    return torch.full((1,), int(x), dtype=torch.int32, device=device)


def _set_row(tree: Tree, slot: int, one: Tree) -> Tree:
    """``tree`` with batch row ``slot`` replaced by ``one``'s only row."""

    def put(full, row):
        out = full.clone()
        out[slot] = row[0]
        return out

    return Tree(*(put(f, r) for f, r in zip(tree, one)))


def seed_slot(tree: Tree, slot: int, token, plen, root_logits, c: int) -> Tree:
    """Re-seed batch row ``slot`` for a newly admitted request (root = last
    prompt token at prefix row ``plen - 1``); root_logits [V]."""
    N = tree.tokens.shape[1]
    dev = tree.tokens.device
    fresh = seed_root(init_tree(N, 1, dev), _row_scalar(token, dev), _row_scalar(plen, dev),
                      root_logits[None], c)
    return _set_row(tree, slot, fresh)


def reset_slot(tree: Tree, slot: int) -> Tree:
    """Park batch row ``slot``: the empty init_tree row (no valid node), so
    expansion and verification skip it until its next admission."""
    return _set_row(tree, slot, init_tree(tree.tokens.shape[1], 1, tree.tokens.device))


# -----------------------------------------------------------------------------
# ancestors / masks
# -----------------------------------------------------------------------------


def ancestor_matrix(tree: Tree):
    """anc[b, i, j] = True iff j is an ancestor-or-self of i (valid nodes).

    The reference follows parent pointers for N steps; here the
    reflexive-transitive closure of the parent relation is taken by
    repeated squaring (paths of length <= 2^k after k squarings), a few
    batched products instead of N dependent gathers."""
    B, N = tree.parent.shape
    ar = _ar(N, tree.parent.device)
    par = tree.parent
    reach = ((par[:, :, None] == ar[None, None, :]) & (par >= 0)[:, :, None]) | torch.eye(
        N, dtype=torch.bool, device=par.device)
    reach = reach.float()
    for _ in range(max(1, (N - 1).bit_length())):
        reach = (torch.bmm(reach, reach) > 0).float()
    return (reach > 0) & tree.valid[:, None, :] & tree.valid[:, :, None]


def rows_mask(tree: Tree, ids, ids_valid, own_rows, S_max: int, window: int = 0):
    """Non-square attention mask [B, k, S_max] for draft nodes ``ids``:
    prefix rows [0, plen) + tree-ancestor rows + own row (self-attention)."""
    B, k = ids.shape
    N = tree.tokens.shape[1]
    cols = _ar(S_max, ids.device)
    idc = ids.clamp(min=0).long()
    anc = ancestor_matrix(tree).gather(1, idc[:, :, None].expand(B, k, N))  # [B, k, N]
    anc &= ids_valid[:, :, None]
    row_of = tree.kv_row
    onehot = (row_of[:, :, None] == cols[None, None, :]) & (row_of >= 0)[:, :, None]
    m_tree = torch.bmm(anc.float(), onehot.float()) > 0
    m_prefix = cols[None, None, :] < tree.plen[:, None, None]
    if window:
        q_pos = tree.plen[:, None] - 1 + _take(tree.depth, idc)
        m_prefix = m_prefix & (cols[None, None, :] > (q_pos[:, :, None] - window))
    m_self = cols[None, None, :] == own_rows[:, :, None]
    return (m_prefix | m_tree | (m_self & ids_valid[:, :, None])) & ids_valid[:, :, None]


# -----------------------------------------------------------------------------
# expansion (paper Alg. 1 lines 3-4, §3.1 maximum-likelihood tree expansion)
# -----------------------------------------------------------------------------


def select_leaves(tree: Tree, w: int):
    """Top-w most probable unexpanded nodes (the priority-queue pop)."""
    score = torch.where(tree.valid & ~tree.expanded, tree.weight, NEG)
    top, ids = top_k(score, w)
    return ids, top > NEG / 2


def leaf_inputs(tree: Tree, leaf_ids, leaf_valid, S_max: int, window: int = 0):
    """Model inputs for expanding ``leaf_ids``.

    Returns (tokens[B,w], rows[B,w], positions[B,w], mask[B,w,S_max],
    new_next_row[B]).  The root writes its KV at prefix row plen-1; other
    leaves get fresh tree-cache rows.  ``leaf_valid`` gates root aliasing:
    a padded leaf id of 0 must not claim the root's row."""
    is_root = (leaf_ids == 0) & leaf_valid
    non_root = leaf_valid & ~is_root
    rank = torch.cumsum(non_root.to(torch.int32), dim=1) - 1
    rows = torch.where(is_root, tree.plen[:, None] - 1,
                       torch.where(non_root, tree.next_row[:, None] + rank, -1))
    rows = _i32(torch.where(rows < S_max, rows, -1))  # cache overflow -> skip
    new_next_row = _i32(tree.next_row + (non_root & (rows >= 0)).sum(1))
    lid = leaf_ids.clamp(min=0)
    tokens = _i32(torch.where(leaf_valid, _take(tree.tokens, lid), 0))
    positions = _i32(torch.where(leaf_valid, tree.plen[:, None] - 1 + _take(tree.depth, lid), 0))
    mask = rows_mask(tree, leaf_ids, leaf_valid & (rows >= 0), rows, S_max, window)
    return tokens, rows, positions, mask, new_next_row


def insert_children(tree: Tree, leaf_ids, leaf_valid, rows, child_tokens, child_logp) -> Tree:
    """Commit one expansion: mark leaves expanded (KV at ``rows``), append
    w*c children with cumulative weights.  Children beyond capacity drop."""
    B, N = tree.tokens.shape
    w, c = child_tokens.shape[1:]
    ar = _ar(N, tree.tokens.device)
    ok = leaf_valid & (rows >= 0)
    hit = (ar[None, None, :] == torch.where(ok, leaf_ids, -2)[:, :, None]).any(1)
    expanded = torch.where(hit, True, tree.expanded)
    kv_row = _scatter(tree.kv_row, leaf_ids, rows, ok)
    next_row = _i32(tree.next_row + (ok & (leaf_ids != 0)).sum(1))
    # flatten children
    pl = torch.where(ok, leaf_ids, 0).repeat_interleave(c, dim=1)  # parent ids [B, w*c]
    pv = ok.repeat_interleave(c, dim=1)
    ct = _i32(child_tokens.reshape(B, w * c))
    cl = child_logp.reshape(B, w * c).float()
    cw = _take(tree.weight, pl) + cl
    cd = _take(tree.depth, pl) + 1
    slot_rank = torch.cumsum(pv.to(torch.int32), dim=1) - 1
    slots = torch.where(pv, tree.n_nodes[:, None] + slot_rank, N)  # N = drop bucket
    keep = pv & (slots < N)
    slots_c = slots.clamp(max=N - 1)
    return Tree(
        tokens=_scatter(tree.tokens, slots_c, ct, keep),
        parent=_scatter(tree.parent, slots_c, pl, keep),
        logp=_scatter(tree.logp, slots_c, cl, keep),
        weight=_scatter(tree.weight, slots_c, cw, keep),
        depth=_scatter(tree.depth, slots_c, cd, keep),
        valid=_scatter(tree.valid, slots_c, torch.ones_like(keep), keep),
        expanded=_scatter(expanded, slots_c, torch.zeros_like(keep), keep),
        kv_row=_scatter(kv_row, slots_c, torch.full_like(ct, -1), keep),
        n_nodes=_i32((tree.n_nodes + keep.sum(1)).clamp(max=N)),
        plen=tree.plen,
        next_row=next_row,
    )


# -----------------------------------------------------------------------------
# verification batch (paper Alg. 1 lines 11-12)
# -----------------------------------------------------------------------------


def select_batch(tree: Tree, bs: int, S_max: int, window: int = 0) -> BatchPlan:
    """Most probable ancestor-closed subgraph of size bs, topologically
    ordered (stable weight sort => parents precede children); slot 0 = root."""
    B, N = tree.tokens.shape
    dev = tree.tokens.device
    score = torch.where(tree.valid, tree.weight, NEG)
    order = torch.argsort(-score, dim=1, stable=True)  # root (weight 0) first
    node_ids = _i32(order[:, :bs])
    valid = _take(tree.valid, node_ids) & (_take(score, node_ids) > NEG / 2)
    slot = _ar(bs, dev)[None, :]
    tokens = _i32(torch.where(valid, _take(tree.tokens, node_ids), 0))
    rows = _i32(torch.where(valid, tree.plen[:, None] - 1 + slot, -1))
    positions = _i32(torch.where(valid, tree.plen[:, None] - 1 + _take(tree.depth, node_ids), 0))
    # parent slot: position of the parent node id within node_ids
    par = _take(tree.parent, node_ids)
    eq = node_ids[:, None, :] == par[:, :, None]  # [B, bs, bs]
    has = eq.any(-1) & (par >= 0)
    parent_pos = _i32(torch.where(has, _first_true(eq), -1))
    # target mask: prefix rows [0, plen-1) + in-batch ancestors (incl. self)
    nid = node_ids.long()
    anc = ancestor_matrix(tree).gather(1, nid[:, :, None].expand(B, bs, N))
    anc = anc.gather(2, nid[:, None, :].expand(B, bs, bs))
    anc &= valid[:, :, None] & valid[:, None, :]
    anc |= torch.eye(bs, dtype=torch.bool, device=dev)[None] & valid[:, :, None]
    cols = _ar(S_max, dev)
    m_prefix = cols[None, None, :] < (tree.plen - 1)[:, None, None]
    if window:
        m_prefix = m_prefix & (cols[None, None, :] > (positions[:, :, None] - window))
    onehot = rows[:, :, None] == cols[None, None, :]
    m_batch = torch.bmm(anc.float(), onehot.float()) > 0
    mask = (m_prefix | m_batch) & valid[:, :, None]
    return BatchPlan(node_ids, tokens, rows, positions, mask, parent_pos, valid)


# -----------------------------------------------------------------------------
# greedy verification walk (target side; paper Alg. 1 lines 15-21)
# -----------------------------------------------------------------------------


def verify_walk(plan_tokens, plan_parent_pos, plan_valid, argmax_tokens):
    """Walk the submitted subgraph under the target's greedy choices.

    Returns (acc_pos i32[B, bs] batch slots of accepted nodes (-1 pad),
    n_acc i32[B], bonus_token i32[B], emitted i32[B, bs+1], n_emitted i32[B]).
    ``emitted`` = accepted tokens then bonus: exactly what target-only
    greedy decoding would produce (the correctness invariant)."""
    B, bs = plan_tokens.shape
    dev = plan_tokens.device
    cur = torch.zeros(B, dtype=torch.int64, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    acc = torch.full((B, bs + 1), -1, dtype=torch.int32, device=dev)  # column bs: drop bucket
    n_acc = torch.zeros(B, dtype=torch.int64, device=dev)
    for _ in range(bs):
        nxt = argmax_tokens.gather(1, cur[:, None])
        is_child = (plan_parent_pos == cur[:, None]) & plan_valid & (plan_tokens == nxt)
        found = is_child.any(1) & alive
        child = _first_true(is_child)
        acc.scatter_(1, torch.where(found, n_acc, bs)[:, None], child[:, None])
        n_acc = n_acc + found
        cur = torch.where(found, child.long(), cur)
        alive = alive & found
    acc = acc[:, :bs]
    bonus = _i32(argmax_tokens.gather(1, cur[:, None]).squeeze(1))
    base = torch.cat([_take(plan_tokens, acc.clamp(min=0)),
                      torch.zeros(B, 1, dtype=torch.int32, device=dev)], dim=1)
    emitted = _i32(torch.where(_ar(bs + 1, dev)[None, :] < n_acc[:, None], base, -1))
    emitted.scatter_(1, n_acc[:, None], bonus[:, None])
    return acc, _i32(n_acc), bonus, emitted, _i32(n_acc + 1)


def predict_accept(tree: Tree, plan_node_ids, plan_parent_pos, plan_valid):
    """The draft's guess at ``verify_walk``'s outcome, from the tree alone
    (the async lookahead bets on it before the target's tokens exist).

    The walk takes the first plan slot whose parent is the current node
    (``select_batch`` orders slots by a stable weight sort, so that is the
    most probable child) and ends when the current node has no child in
    the plan; there is no token check.  The predicted bonus is the
    lowest-indexed (most probable) child of the last node in the full
    tree, or -1 when it has none — a value no real bonus takes.  The walk
    is a loop of ``bs`` steps on tensors, with no host sync.

    Returns (acc i32[B, bs] predicted slots (-1 pad), n_acc i32[B],
    bonus i32[B])."""
    B, bs = plan_node_ids.shape
    dev = plan_node_ids.device
    cur = torch.zeros(B, dtype=torch.int64, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    acc = torch.full((B, bs + 1), -1, dtype=torch.int32, device=dev)  # column bs: drop bucket
    n_acc = torch.zeros(B, dtype=torch.int64, device=dev)
    for _ in range(bs):
        is_child = (plan_parent_pos == cur[:, None]) & plan_valid
        found = is_child.any(1) & alive
        child = _first_true(is_child)
        acc.scatter_(1, torch.where(found, n_acc, bs)[:, None], child[:, None])
        n_acc = n_acc + found
        cur = torch.where(found, child.long(), cur)
        alive = alive & found
    last_node = _take(plan_node_ids, cur[:, None])  # plan slot -> tree node (root if none)
    is_c = (tree.parent == last_node) & tree.valid
    bonus = torch.where(is_c.any(1), _take(tree.tokens, _first_true(is_c)[:, None]).squeeze(1), -1)
    return acc[:, :bs], _i32(n_acc), _i32(bonus)


# -----------------------------------------------------------------------------
# re-root + compaction (paper §3.2, Fig. 5)
# -----------------------------------------------------------------------------


def reroot(tree: Tree, batch_node_ids, acc_pos, n_acc, bonus):
    """Re-root at the bonus token; keep the surviving subtree; emit KV plans.

    Returns (tree', MovePlan, FillPlan).
      MovePlan — draft-cache row moves: accepted-path KV into prefix rows,
        surviving expanded nodes compacted into the new tree region.
      FillPlan — accepted tokens whose KV was never computed (unexpanded
        accepted nodes): one masked draft forward fills them."""
    B, n = tree.tokens.shape
    bs = batch_node_ids.shape[1]
    dev = tree.tokens.device
    ar = _ar(n, dev)[None, :]
    arb = _ar(bs, dev)[None, :]
    plen_new = _i32(tree.plen + n_acc + 1)

    # accepted tree nodes, in path order
    acc_nodes = torch.where(acc_pos >= 0, _take(batch_node_ids, acc_pos.clamp(min=0)), -1)
    acc_ok = arb < n_acc[:, None]
    last_node = torch.where(
        n_acc > 0, _take(acc_nodes, (n_acc - 1).clamp(min=0)[:, None]).squeeze(1), 0)

    # new root: child of last_node carrying the bonus token, if present
    is_new_root = (tree.parent == last_node[:, None]) & tree.valid & (tree.tokens == bonus[:, None])
    root_exists = is_new_root.any(1)
    new_root = _i32(torch.where(root_exists, _first_true(is_new_root), -1))
    nr = new_root.clamp(min=0).long()

    # survivors: descendants-or-self of new_root
    anc = ancestor_matrix(tree)
    col = anc.gather(2, nr[:, None, None].expand(B, n, 1)).squeeze(2)
    surv = root_exists[:, None] & col & tree.valid
    surv_nonroot = surv & (ar != new_root[:, None])

    # --- new node index mapping: root -> 0, others ranked by old index -----
    rank = torch.cumsum(surv_nonroot.to(torch.int32), dim=1) - 1
    new_idx = _i32(torch.where(surv_nonroot, 1 + rank,
                               torch.where(ar == new_root[:, None], 0, -1)))
    m = _i32(surv_nonroot.sum(1))

    # --- KV row moves --------------------------------------------------------
    # (1) accepted path nodes with KV -> prefix rows plen + i
    src_a = _i32(torch.where(acc_ok, _take(tree.kv_row, acc_nodes.clamp(min=0)), -1))
    dst_a = _i32(torch.where(acc_ok, tree.plen[:, None] + arb, -1))
    mask_a = acc_ok & (src_a >= 0)
    # (2) new root with KV -> prefix row plen_new - 1
    root_kv = _i32(torch.where(root_exists, _take(tree.kv_row, nr[:, None]).squeeze(1), -1))
    src_r = root_kv[:, None]
    dst_r = (plen_new - 1)[:, None]
    mask_r = root_exists[:, None] & (src_r >= 0)
    # (3) surviving expanded non-root nodes -> compacted tree rows
    has_kv = surv_nonroot & (tree.kv_row >= 0)
    kv_rank = torch.cumsum(has_kv.to(torch.int32), dim=1) - 1
    src_s = _i32(torch.where(has_kv, tree.kv_row, -1))
    dst_s = _i32(torch.where(has_kv, plen_new[:, None] + kv_rank, -1))
    move = MovePlan(
        src=torch.cat([src_a, src_r, src_s], dim=1),
        dst=torch.cat([dst_a, dst_r, dst_s], dim=1),
        mask=torch.cat([mask_a, mask_r, has_kv], dim=1),
    )
    next_row_new = _i32(plen_new + has_kv.sum(1))

    # --- fill plan: accepted nodes WITHOUT KV (their new prefix rows) -------
    fill_tok = _i32(torch.where(acc_ok, _take(tree.tokens, acc_nodes.clamp(min=0)), 0))
    fill_rows = _i32(torch.where(acc_ok & (src_a < 0), dst_a, -1))
    fill = FillPlan(
        tokens=fill_tok,
        rows=fill_rows,
        positions=_i32(torch.where(fill_rows >= 0, fill_rows, 0)),  # prefix: position == row
        mask=fill_rows >= 0,
    )

    # --- rebuild node arrays -------------------------------------------------
    gather_src = torch.argsort(torch.where(new_idx >= 0, new_idx, n), dim=1, stable=True)
    live_new = ar < (1 + m)[:, None]
    is0 = ar == 0

    def g(a, fill_val):
        return torch.where(live_new, a.gather(1, gather_src), fill_val)

    root_w = torch.where(root_exists, _take(tree.weight, nr[:, None]).squeeze(1), 0.0)
    root_d = torch.where(root_exists, _take(tree.depth, nr[:, None]).squeeze(1), 0)
    new_parent = torch.where(
        live_new, torch.where(is0, -1, _take(new_idx, g(tree.parent, -1).clamp(min=0))), -1)
    # kv_row remap: moved rows — accepted/surviving nodes get their dst rows
    kv_new_row = torch.where(has_kv, dst_s, -1)  # old-index space
    kv_root_row = _i32(torch.where(root_exists & (root_kv >= 0), plen_new - 1, -1))
    kv_new_row = torch.where(ar == new_root[:, None], kv_root_row[:, None], kv_new_row)
    root_expanded = root_exists & _take(tree.expanded, nr[:, None]).squeeze(1)

    t = Tree(
        tokens=_i32(torch.where(is0, bonus[:, None], g(tree.tokens, 0))),
        parent=_i32(new_parent),
        logp=torch.where(is0, 0.0, g(tree.logp, 0.0)),
        weight=torch.where(is0, 0.0, g(tree.weight, NEG) - root_w[:, None]),
        depth=_i32(torch.where(is0, 0, g(tree.depth, 0) - root_d[:, None])),
        valid=live_new,
        expanded=torch.where(is0, root_expanded[:, None], g(tree.expanded, False)),
        kv_row=_i32(torch.where(is0, kv_root_row[:, None], g(kv_new_row, -1))),
        n_nodes=_i32(1 + m),
        plen=plen_new,
        next_row=next_row_new,
    )
    return t, move, fill
