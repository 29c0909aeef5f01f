"""The port's lockstep round (``repro_torch.core.engine``) against the JAX
package's, on the ``dense_pair`` weights converted with ``params_from_numpy``.

``generate`` must emit the same tokens as the reference in parallel, serial
and draft-bypass mode, with ``SpecStats.rounds``, ``emitted_rows``,
``accepted_rows`` and ``draft_steps`` exactly equal, and the same tokens as
the port's own target-only greedy decode.  The serving CLI must run on the
CPU when asked to.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro.sharding import Param
from repro_torch.configs import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import SpecConfig, SpecEngine, SpecStats, absorb_emitted
from repro_torch.launch import serve
from repro_torch.models.api import make_model
from test_torch_model import port_greedy

S_MAX = 256
BASE = dict(bs=8, w=4, c=2, d=2, n_cap=64, max_new=24)


def unbox(tree):
    return jax.tree.map(lambda p: np.asarray(p.value), tree,
                        is_leaf=lambda x: isinstance(x, Param))


@pytest.fixture(scope="module")
def pair(dense_pair):
    """JAX engines (independent draft, self draft) and the port's models and
    converted weights.  A JAX engine's jitted programs depend on bs, w and c
    only, so one engine serves every mode by swapping its ``cfg``, as the
    reference CLI does after its profile pass."""
    T, D, tp, dp = dense_pair
    jeng = {False: JSpecEngine(T, D, JSpecConfig(**BASE), S_max_t=S_MAX, S_max_d=S_MAX),
            True: JSpecEngine(T, T, JSpecConfig(**BASE), S_max_t=S_MAX, S_max_d=S_MAX)}
    cfgT = ModelConfig(**dataclasses.asdict(T.cfg))
    cfgD = ModelConfig(**dataclasses.asdict(D.cfg))
    port = (make_model(cfgT, "cpu"), make_model(cfgD, "cpu"),
            params_from_numpy(cfgT, unbox(tp), "cpu"), params_from_numpy(cfgD, unbox(dp), "cpu"))
    return jeng, (tp, dp), port


@pytest.mark.parametrize("mode,bypass,self_draft,B", [
    ("parallel", False, False, 1),
    ("serial", False, False, 1),
    ("parallel", True, False, 1),
    ("parallel", False, True, 1),  # draft = target: deep acceptance, many row moves
    ("serial", False, True, 1),
    ("parallel", False, True, 2),  # rows of one batch accept different depths
])
def test_generate_matches_reference(pair, mode, bypass, self_draft, B):
    jeng, (jtp, jdp), (T, D, tp, dp) = pair
    kw = dict(BASE, mode=mode, draft_bypass=bypass)
    je = jeng[self_draft]
    je.cfg = JSpecConfig(**kw)
    prompt = ((np.arange(B * 8, dtype=np.int32).reshape(B, 8) * 3 + 1) % 128).astype(np.int32)
    jout, jst = je.session(jtp, jtp if self_draft else jdp).generate(prompt)
    eng = SpecEngine(T, T if self_draft else D, SpecConfig(**kw), S_max_t=S_MAX, S_max_d=S_MAX)
    out, st = eng.session(tp, tp if self_draft else dp).generate(prompt)
    assert out == jout
    assert st.rounds == jst.rounds and st.draft_steps == jst.draft_steps
    np.testing.assert_array_equal(st.emitted_rows, jst.emitted_rows)
    np.testing.assert_array_equal(st.accepted_rows, jst.accepted_rows)
    assert out == port_greedy(T, tp, prompt, BASE["max_new"])
    if self_draft and not bypass:
        assert st.accepted > 0, "self-draft must accept draft tokens"


def test_step_result_and_depth(pair):
    """``step(depth=...)`` runs that many expansions; the emitted row holds
    accepted tokens then the bonus token."""
    _, _, (T, D, tp, dp) = pair
    eng = SpecEngine(T, T, SpecConfig(**BASE), S_max_t=S_MAX, S_max_d=S_MAX)
    sess = eng.session(tp, tp)
    prompt = (np.arange(8, dtype=np.int32) + 5).reshape(1, 8)
    sess.state = eng._prefill_state(tp, tp, prompt)
    stats = SpecStats()
    res = sess.step(stats=stats, depth=3)
    assert stats.draft_steps == 3 + eng.grow_per_round and stats.rounds == 1
    n = int(res.n_emitted[0])
    assert n == int(res.n_accepted[0]) + 1 and (res.emitted[0, :n] >= 0).all()
    with pytest.raises(ValueError):
        sess.step(depth=0)


def test_absorb_emitted_stops_at_max_new_and_eos():
    out = [1, 2]
    new, done = absorb_emitted(out, np.array([7, 8, 9, -1]), 3, max_new=4, eos_id=-1)
    assert new == [7, 8] and done and out == [1, 2, 7, 8]
    out = []
    new, done = absorb_emitted(out, np.array([3, 5, 6]), 3, max_new=10, eos_id=5)
    assert new == [3, 5] and done


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--d", "1", "--requests", "2", "--max-new", "12"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["req 0", "req 1"]
    assert "12 tokens" in lines[0] and lines[-1].startswith("aggregate:")


def test_serve_cli_profiles_depth_and_refuses_later_slices(capsys):
    """The profile pass picks d; the fleet flags (once refused) now serve a
    continuous trace over two replicas sharing the one CPU device, with the
    fleet report and every output checked against its solo generate()."""
    serve.main(["--device", "cpu", "--requests", "1", "--max-new", "8", "--mode", "serial"])
    out = capsys.readouterr().out
    assert out.startswith("profile: t_draft=") and "(serial mode)" in out
    serve.main(["--device", "cpu", "--continuous", "--replicas", "2", "--n-target", "1",
                "--n-draft", "1", "--d", "1", "--requests", "4", "--max-new", "8"])
    out = capsys.readouterr().out
    assert "(2 replicas x 2 slots" in out
    assert "replica 0:" in out and "replica 1:" in out and "fleet: 4 finished" in out
    assert out.count("byte-identical to solo generate() (replica") == 4
