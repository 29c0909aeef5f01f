"""The port's mixture of experts (``repro_torch.models.moe``) against the JAX
package's ``moe_apply`` on the same weights, at module level.

The smoke configs of mixtral-8x22b (4 experts, top 2, no shared expert) and
deepseek-moe-16b (8 experts, top 3, 2 shared experts), each also with the
shared experts switched the other way, run drop-free (the smoke configs'
capacity_factor 8.0) and with drops (capacity_factor 1.25 over T = 16
rows, 12 of them equal, so their experts get more pairs than slots): the
same pairs must be kept on both sides and the outputs agree at atol = rtol
= 1e-4 in float32.  A repeated call gives the same bits (no atomics in the combine).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import ModelConfig, get_config
from repro_torch.models import moe
from test_torch_model import unbox

TOL = dict(atol=1e-4, rtol=1e-4)
CASES = {  # id -> (config, n_shared_experts or None for the config's own)
    "mixtral": ("mixtral-8x22b", None), "mixtral+shared": ("mixtral-8x22b", 1),
    "deepseek-moe": ("deepseek-moe-16b", None), "deepseek-moe-no-shared": ("deepseek-moe-16b", 0),
}
CAPACITY = {"drop-free": 8.0, "drops": 1.25}
# rows that repeat row 0, spread over both batch rows: their experts get 12
# pairs, past capacity 1.25 (10 slots for mixtral's 4 experts, 8 for
# deepseek-moe's 8), and the stable sort keeps the earliest rows
HOT = [0, 1, 3, 4, 6, 7, 9, 10, 12, 13, 14, 15]


def _setup(case, cap_id, seed=0):
    """(reference cfg, reference params, port cfg, routed, shared, x [2, 8, d])."""
    name, n_shared = CASES[case]
    jcfg = jget_config(name, smoke=True)
    kw = {"capacity_factor": CAPACITY[cap_id]}
    if n_shared is not None:
        kw["n_shared_experts"] = n_shared
    jcfg = dataclasses.replace(jcfg, **kw)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    p = unbox(jp)
    shared = p.pop("shared", None)
    routed = {k: torch.tensor(v) for k, v in p.items()}
    shared = None if shared is None else {k: torch.tensor(v) for k, v in shared.items()}
    x = np.random.default_rng(seed).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    x.reshape(16, -1)[HOT] = x[0, 0]  # 12 of the 16 rows pick the same experts
    return jcfg, jp, cfg, routed, shared, x


@pytest.mark.parametrize("cap_id", sorted(CAPACITY))
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case, cap_id):
    jcfg, jp, cfg, routed, shared, x = _setup(case, cap_id)
    want = np.asarray(jmoe.moe_apply(jcfg, jp, jax.numpy.asarray(x)))
    got = moe.moe_apply(cfg, routed, shared, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, err_msg=f"{case} {cap_id}", **TOL)
    again = moe.moe_apply(cfg, routed, shared, torch.tensor(x))
    assert torch.equal(again, got), "two calls on the same input differ"


@pytest.mark.parametrize("cap_id", sorted(CAPACITY))
@pytest.mark.parametrize("case", ["mixtral", "deepseek-moe"])
def test_dispatch_keeps_and_drops_the_reference_pairs(case, cap_id):
    """``route`` keeps exactly the (row, buffer slot) pairs that the
    reference's ``_dispatch`` keeps, with the same weights; with drops,
    some pair is dropped, and none is without."""
    jcfg, jp, cfg, routed, shared, x = _setup(case, cap_id, seed=1)
    T = x.shape[0] * x.shape[1]
    cap = moe.capacity(cfg, T)
    E, k = cfg.n_experts, cfg.moe_top_k
    x2d = x.reshape(T, -1)
    _, (jdest, jtok, jw) = jmoe._dispatch(jax.numpy.asarray(x2d), jp["router"].value, E, k, cap)
    want = {(int(t), int(d)): float(w) for t, d, w in zip(np.asarray(jtok), np.asarray(jdest),
                                                           np.asarray(jw)) if d < E * cap}
    dest, w = moe.route(torch.tensor(x2d), routed["router"], E, k, cap)
    got = {(t, int(dest[t, j])): float(w[t, j]) for t in range(T) for j in range(k)
           if dest[t, j] < E * cap}
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[key] for key in sorted(want)],
                               [want[key] for key in sorted(want)], **TOL)
    dropped = int((dest == E * cap).sum())
    assert dropped == T * k - len(want)
    assert (dropped > 0) == (cap_id == "drops"), (dropped, cap)
    assert torch.all(w[dest == E * cap] == 0)


def test_capacity_is_the_references_rule():
    cfg = get_config("deepseek-moe-16b")
    assert [moe.capacity(cfg, T) for T in (1, 8, 16)] == [1, 1, 2]  # capacity_factor 1.25
    drop_free = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    assert all(moe.capacity(drop_free, T) >= T for T in range(1, 65))
