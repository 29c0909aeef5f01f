"""The port's single-device training substrate against the JAX package's:
``optim`` (AdamW, the global-norm clip, ``warmup_cosine``, int8
compression), ``data.SyntheticLMDataset``, ``ckpt.CheckpointManager``,
``runtime.fault``, ``launch.steps`` and the ``launch.train`` driver.

Oracles: ``tests/test_substrate.py``.  Where the reference's XLA arithmetic
is not IEEE op by op (its f32 ``cos``, and the fused AdamW update of an
element), the port is held to the reference's value within a few f32
roundings and to exact equality where both sides must be exact: the first
update's moments, a norm whose terms sum exactly, the dataset's tokens and
the int8 codes.
"""

import math
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JSyntheticLMDataset
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import compress_int8 as jcompress_int8
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.runtime import StragglerPolicy as JStragglerPolicy
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.engine import SpecConfig, SpecEngine
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train
from repro_torch.models.api import make_model
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    compress_int8,
    decompress_int8,
    warmup_cosine,
)
from repro_torch.runtime import FaultConfig, StragglerPolicy, retry_step

TINY = ModelConfig(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                   vocab_size=64)


def _np(t):
    return np.asarray(t.detach()) if isinstance(t, torch.Tensor) else np.asarray(t)


# -------------------------------------------------------------- optimizer


def _adamw_both(params, grads_per_step, lrs, **kw):
    """The same updates through the reference's AdamW and the port's:
    [(reference params, state), (port params, state)] after each step."""
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    js = jadamw_init(jp)
    tp = [torch.tensor(p) for p in params]
    ts = adamw_init(tp)
    out = []
    for grads, lr in zip(grads_per_step, lrs):
        jp, js = jadamw_update({str(i): jnp.asarray(g) for i, g in enumerate(grads)}, js, jp,
                               lr, **kw)
        tp, ts = adamw_update([torch.tensor(g) for g in grads], ts, tp, lr, **kw)
        out.append(((jp, js), (tp, ts)))
    return out


def test_adamw_first_update_is_bit_exact_and_later_ones_within_a_rounding():
    rng = np.random.default_rng(0)
    shapes = [(64, 32), (128,), (7, 5, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    lrs = [np.float32(1e-2), np.float32(5e-3), np.float32(2e-3)]
    steps = _adamw_both(params, grads, lrs)
    for k, ((jp, js), (tp, ts)) in enumerate(steps):
        assert ts.step == int(js.step) == k + 1
        for i in range(len(shapes)):
            mu, jmu = _np(ts.mu[i]), np.asarray(js.mu[str(i)])
            nu, jnu = _np(ts.nu[i]), np.asarray(js.nu[str(i)])
            if k == 0:  # m = 0.1 g, v = 0.05 g², one rounding each, same on both sides
                np.testing.assert_array_equal(mu, jmu)
                np.testing.assert_array_equal(nu, jnu)
            np.testing.assert_allclose(mu, jmu, rtol=1e-6, atol=1e-6 * np.abs(jmu).max())
            np.testing.assert_allclose(nu, jnu, rtol=1e-6, atol=1e-6 * np.abs(jnu).max())
            w, jw = _np(tp[i]), np.asarray(jp[str(i)])
            np.testing.assert_allclose(w, jw, rtol=1e-6, atol=1e-7 * np.abs(jw).max())
            np.testing.assert_array_equal(_np(ts.master[i]), w)


def test_adamw_clip_is_exact_when_the_norm_is():
    """Integer gradients: every partial sum of squares is exact in f32, so the
    global norm, the clip scale and the moments equal the reference's bit
    for bit, clipped (norm 4·√(Σ) > 1) and not."""
    rng = np.random.default_rng(1)
    shapes = [(16, 8), (5,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[np.round(rng.normal(size=s) * 4).astype(np.float32) for s in shapes]
             for _ in range(2)]
    for clip in (1.0, 1e9):
        for (jp, js), (tp, ts) in _adamw_both(params, grads, [0.1, 0.1], grad_clip=clip):
            for i in range(len(shapes)):
                np.testing.assert_array_equal(_np(ts.mu[i]), np.asarray(js.mu[str(i)]))
                np.testing.assert_array_equal(_np(ts.nu[i]), np.asarray(js.nu[str(i)]))
    _, (_, ts) = _adamw_both([np.zeros(3, np.float32)], [[np.full(3, 100.0, np.float32)]],
                             [0.1], grad_clip=1.0)[0]
    assert float(torch.sqrt(torch.sum(ts.mu[0] ** 2))) / 0.1 <= 1.0 + 1e-4  # clipped to 1


def test_adamw_reference_step_decay_on_every_leaf_and_no_aliasing():
    params = [torch.full((4,), 2.0)]
    st = adamw_init(params)
    new, st2 = adamw_update([torch.full((4,), 0.5)], st, params, 0.1, weight_decay=0.0,
                            grad_clip=1e9)
    np.testing.assert_allclose(_np(new[0]), 2.0 - 0.1, rtol=1e-5)  # step 1: update = lr
    assert st2.step == 1 and st.step == 0 and torch.equal(params[0], torch.full((4,), 2.0))
    # decoupled decay hits a leaf with a zero (or missing) gradient
    new, _ = adamw_update([None], st, params, 0.1, weight_decay=0.1)
    np.testing.assert_allclose(_np(new[0]), 2.0 - 0.1 * 0.1 * 2.0, rtol=1e-6)
    for dt in (torch.float32, torch.bfloat16):
        p = [torch.ones(8, dtype=dt)]
        s = adamw_init(p)
        assert s.master[0].dtype == torch.float32
        assert s.master[0].data_ptr() != p[0].data_ptr()
        new, s2 = adamw_update([torch.ones(8, dtype=dt)], s, p, 0.1)
        assert new[0].dtype == dt and new[0].data_ptr() != s2.master[0].data_ptr()


def test_adamw_on_a_module_returns_a_new_module():
    model = make_model(TINY, "cpu")
    params = model.init(0, trainable=True)
    st = adamw_init(params)
    grads = [torch.ones_like(p) for p in params.parameters()]
    new, _ = adamw_update(grads, st, params, 0.1)
    assert type(new) is type(params) and new is not params
    for (n, p), (n2, q) in zip(params.named_parameters(), new.named_parameters()):
        assert n == n2 and q.requires_grad and not torch.equal(p, q)
        assert p.data_ptr() != q.data_ptr()


# -------------------------------------------------------------- schedule


def test_warmup_cosine_matches_reference():
    """The warmup branch and the final plateau bit for bit; the cosine branch
    within what one last bit of cos makes of the rate: XLA's f32 cos and
    torch's differ in their last bit at some arguments (at most f32's
    epsilon below 1), which the schedule scales by 0.45 peak, plus two
    roundings of the rate itself."""
    kw = dict(peak_lr=3e-4, warmup_steps=20, total_steps=250)
    for s in range(300):
        got, want = warmup_cosine(s, **kw).numpy(), np.float32(jwarmup_cosine(s, **kw))
        assert got.dtype == np.float32
        if s < 20 or s >= 250:
            assert got == want, s
        else:
            cos_bit = 0.5 * (1 - 0.1) * kw["peak_lr"] * np.finfo(np.float32).eps
            assert abs(got - want) <= cos_bit + 2 * np.spacing(want), s
    lr = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10, total_steps=100))
          for s in range(100)]
    assert lr[0] == 0.0 and abs(lr[10] - 1.0) < 0.11
    assert lr[99] < lr[50] < lr[10] and lr[99] >= 0.1 - 1e-6


# -------------------------------------------------------------- compression


@pytest.mark.parametrize("seed", range(8))
def test_int8_round_trip_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(257,)) * 10.0 ** rng.uniform(-4, 2)).astype(np.float32)
    q, s = compress_int8(torch.tensor(x))
    jq, js = jcompress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy() == np.float32(js)
    err = np.max(np.abs(decompress_int8(q, s).numpy() - x))
    assert err <= float(s) / 2 + 1e-7  # half a step of the int8 grid
    q0, s0 = compress_int8(torch.zeros(5))
    assert not q0.any() and float(s0) == np.float32(1e-12)


# -------------------------------------------------------------- data


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [(100, 16, 4, 1, 5), (50, 64, 8, 0, 0),
                                                      (128256, 32, 2, 0, 3), (64, 16, 2, 3, 7)])
def test_synthetic_dataset_matches_reference_bit_for_bit(vocab, seq, batch, seed, step):
    ds = SyntheticLMDataset(DataConfig(vocab, seq, batch, seed=seed))
    jds = JSyntheticLMDataset(JDataConfig(vocab, seq, batch, seed=seed))
    a = ds.batch(step)["tokens"]
    np.testing.assert_array_equal(a, jds.batch(step)["tokens"])
    assert a.shape == (batch, seq + 1) and a.dtype == np.int32
    np.testing.assert_array_equal(a, ds.batch(step)["tokens"])
    assert not np.array_equal(a, ds.batch(step + 1)["tokens"])


# -------------------------------------------------------------- checkpoints


def test_ckpt_roundtrip_gc_and_dtypes():
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=2)
        bf = torch.randn(2, 3).to(torch.bfloat16)
        state = {"a": torch.arange(5.0), "b": {"c": bf}, "n": 7, "t": (torch.ones(2), None)}
        for s in (3, 7, 9):
            cm.save(s, state, blocking=True)
        assert cm.all_steps() == [7, 9]  # GC keeps 2
        s, restored = cm.restore_latest(state)
        assert s == 9 and restored["n"] == 7 and restored["t"][1] is None
        np.testing.assert_array_equal(restored["a"].numpy(), np.arange(5.0))
        assert restored["b"]["c"].dtype == torch.bfloat16 and torch.equal(restored["b"]["c"], bf)


def test_ckpt_async_then_wait_and_snapshot_before_return():
    """``save`` returns with its host copy complete: an in-place update right
    after it (the optimizer's next step) does not reach the checkpoint."""
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=3)
        w = torch.zeros((128, 128))
        cm.save(1, {"w": w}, blocking=False)
        w.add_(1.0)
        cm.wait()
        assert cm.latest_step() == 1
        _, restored = cm.restore_latest({"w": w})
        assert not restored["w"].any()


def test_ckpt_ignores_and_sweeps_partial_writes():
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=3)
        cm.save(5, {"x": torch.ones(3)}, blocking=True)
        tmp = os.path.join(d, "step_000000000009.tmp-dead")
        os.makedirs(tmp)
        os.makedirs(os.path.join(d, "step_000000000010"))  # no MANIFEST -> invalid
        assert cm.latest_step() == 5
        s, _ = cm.restore_latest({"x": torch.ones(3)})
        assert s == 5 and not os.path.exists(tmp)


def test_ckpt_resume_is_bit_exact():
    """Train 6 steps against 3 + save + restore + 3: identical params and
    optimizer state (the functional step never writes the state it read)."""
    model = make_model(TINY, "cpu")
    ds = SyntheticLMDataset(DataConfig(TINY.vocab_size, 16, 2, seed=3))
    step = make_train_step(TINY, model)

    def run(params, opt, lo, hi):
        for s in range(lo, hi):
            params, opt, _ = step(params, opt, ds.batch(s))
        return params, opt

    p0 = model.init(0, trainable=True)
    o0 = adamw_init(p0)
    pa, oa = run(p0, o0, 0, 6)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        pb, ob = run(p0, o0, 0, 3)
        cm.save(2, (pb, ob), blocking=True)
        s, (pr, orr) = cm.restore_latest((pb, ob))
        assert s == 2 and orr.step == 3
        assert all(p.requires_grad for p in pr.parameters())
        pc, oc = run(pr, orr, 3, 6)
    for a, b in zip(list(pa.parameters()) + oa.mu + oa.nu + oa.master,
                    list(pc.parameters()) + oc.mu + oc.nu + oc.master):
        assert torch.equal(a, b)
    assert oa.step == oc.step == 6


# -------------------------------------------------------------- fault / steps


def test_retry_step_recovers_and_gives_up():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return 42

    assert retry_step(flaky, FaultConfig(backoff_s=0.001)) == 42 and len(calls) == 3

    def always():
        raise RuntimeError("a kernel that does not launch")

    with pytest.raises(RuntimeError, match="does not launch"):
        retry_step(always, FaultConfig(max_retries=2, backoff_s=0.001))
    with pytest.raises(ValueError):  # not transient: no retry
        retry_step(lambda: (_ for _ in ()).throw(ValueError("bad")), FaultConfig())


def test_straggler_policy_matches_reference():
    for times in ([0.015], [0.015, 0.05], [0.05, 0.015], []):
        sp, jsp = (cls(t_draft_profiled_s=0.01, deadline_ratio=2.0)
                   for cls in (StragglerPolicy, JStragglerPolicy))
        for t in times:
            sp.observe(t)
            jsp.observe(t)
        assert sp.should_bypass() == jsp.should_bypass() and sp.deadline_s == jsp.deadline_s


@pytest.mark.parametrize("where", ["update", "forward"])
def test_a_transient_failure_in_a_step_ends_in_the_clean_state(monkeypatch, where):
    """A step that raises once — in the optimizer after the gradients, or in
    the forward — then runs again under ``retry_step`` ends in the state of
    a clean step, bit for bit: nothing was written before the failure."""
    model = make_model(TINY, "cpu")
    batch = SyntheticLMDataset(DataConfig(TINY.vocab_size, 16, 2)).batch(0)
    p0 = model.init(0, trainable=True)
    o0 = adamw_init(p0)
    clean_p, clean_o, clean_loss = make_train_step(TINY, model, warmup_steps=1)(p0, o0, batch)
    snapshot = [p.detach().clone() for p in p0.parameters()]
    fails = []
    if where == "update":
        real = steps_mod.adamw_update

        def flaky(*a, **k):
            out = real(*a, **k)
            if not fails:
                fails.append(1)
                raise RuntimeError("transient")
            return out

        monkeypatch.setattr(steps_mod, "adamw_update", flaky)
    else:
        from repro_torch.kernels import ops

        real_swiglu = ops.fused_swiglu

        def flaky(*a, **k):
            if not fails:
                fails.append(1)
                raise RuntimeError("transient")
            return real_swiglu(*a, **k)

        monkeypatch.setattr(ops, "fused_swiglu", flaky)
    step = make_train_step(TINY, model, warmup_steps=1)
    p, o, loss = retry_step(lambda: step(p0, o0, batch), FaultConfig(backoff_s=0.001))
    assert fails == [1] and torch.equal(loss, clean_loss) and o.step == clean_o.step == 1
    for a, b in zip(list(p.parameters()) + o.mu + o.nu + o.master,
                    list(clean_p.parameters()) + clean_o.mu + clean_o.nu + clean_o.master):
        assert torch.equal(a, b)
    for a, b in zip(p0.parameters(), snapshot):  # the step's inputs are as they were
        assert torch.equal(a, b)


def test_grad_compress_pod_without_a_pod_group_changes_nothing():
    model = make_model(TINY, "cpu")
    batch = SyntheticLMDataset(DataConfig(TINY.vocab_size, 16, 2)).batch(1)
    p0 = model.init(0, trainable=True)
    o0 = adamw_init(p0)
    a = make_train_step(TINY, model, warmup_steps=1)(p0, o0, batch)
    b = make_train_step(TINY, model, warmup_steps=1, grad_compress_pod=True)(p0, o0, batch)
    assert torch.equal(a[2], b[2])
    for x, y in zip(a[0].parameters(), b[0].parameters()):
        assert torch.equal(x, y)


def test_serving_refuses_trainable_weights_and_init_freezes_by_default():
    model = make_model(TINY, "cpu")
    frozen, trainable = model.init(0), model.init(0, trainable=True)
    assert not any(p.requires_grad for p in frozen.parameters())
    assert all(p.requires_grad for p in trainable.parameters())
    eng = SpecEngine(model, model, SpecConfig(bs=4, w=2, c=2, d=1), 64, 64)
    with pytest.raises(ValueError, match="frozen"):
        eng.session(trainable, frozen)
    eng.session(frozen, frozen)


# -------------------------------------------------------------- the driver


def test_train_cli_improves_and_resumes_bit_exact(capsys):
    """The CLI on the CPU: the loss improves.  A run of 8 steps stopped
    after step 5 (as a preemption would: checkpoints at steps 2 and 4) and
    restarted resumes at step 5 and ends with the losses and params of an
    uninterrupted run, the cosine schedule past its warmup included."""
    with tempfile.TemporaryDirectory() as d:
        first, last = train_main(["--device", "cpu", "--arch", "llama3-1b", "--steps", "30",
                                  "--batch", "4", "--seq", "16", "--log-every", "10"])
        out = capsys.readouterr().out
        assert "(improved)" in out and last < first
        cfg = get_config("llama3-1b", smoke=True)
        kw = dict(steps=8, batch=2, seq=16, warmup_steps=2, device="cpu", log=lambda *_: None)
        whole = train(cfg, **kw)
        cut = train(cfg, ckpt=d, ckpt_every=2, stop_at=6, **kw)
        assert len(cut["losses"]) == 6 and CheckpointManager(d).all_steps() == [2, 4]
        lines = []
        resumed = train(cfg, ckpt=d, ckpt_every=2, **{**kw, "log": lines.append})
        assert resumed["start"] == 5 and "resumed from step 4" in lines
        assert resumed["losses"] == whole["losses"][5:] and cut["losses"] == whole["losses"][:6]
        for a, b in zip(resumed["params"].parameters(), whole["params"].parameters()):
            assert torch.equal(a, b)
        assert math.isfinite(whole["first"]) and len(whole["step_s"]) == 8


def test_ckpt_background_write_error_reaches_wait(monkeypatch):
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)

        def broken(*a):
            raise OSError("disk full")

        monkeypatch.setattr(cm, "_write", broken)
        cm.save(1, {"x": torch.ones(2)})
        with pytest.raises(OSError, match="disk full"):
            cm.wait()
        cm.wait()  # reported once
        assert cm.latest_step() is None
