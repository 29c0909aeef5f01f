"""Tensor parallelism in one process: the port's ``resolve_for_tp``,
``spec_for``, ``pad_params`` and ``reshard_params`` against the JAX
package's, and the per-rank layout (``repro_torch.parallel.shard``).

``resolve_for_tp`` must equal the reference field for field on all 15
configs, full and smoke, at tp 1, 2, 3, 4, 6 and 8; ``spec_for`` the
reference's on its fake meshes and on drawn axes, shapes and meshes;
``pad_params`` must give the reference's padded weights bit for bit, and
the padded port model's ``forward_train`` the reference's unpadded forward
at the reference's own 2e-4 (``tests/test_sharding.py:48-65``).  The
multi-process runs are in ``test_torch_tp_forward.py`` and
``test_torch_tp_engine.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.configs import resolve_for_tp as jresolve_for_tp
from repro.models.api import make_model as jmake_model
from repro.models.padding import pad_params as jpad_params
from repro.sharding import DEFAULT_RULES as JDEFAULT_RULES
from repro.sharding import spec_for as jspec_for
from repro_torch.configs import PORTED, ModelConfig, get_config, resolve_for_tp
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import SpecConfig, SpecEngine
from repro_torch.models.api import make_model
from repro_torch.models.padding import pad_params, unpad_tensor
from repro_torch.models.transformer import param_where
from repro_torch.parallel import DEFAULT_RULES, TPGroup, spec_for
from repro_torch.parallel.group import check_backend
from repro_torch.parallel.shard import Shard, attn_layout, shard_params, unshard_params
from repro_torch.parallel.spawn import run_ranks
from repro_torch.runtime import reshard_params
from test_torch_model import unbox

TPS = (1, 2, 3, 4, 6, 8)


def port_config(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", PORTED)
def test_resolve_for_tp_is_the_reference(arch, tp):
    for smoke in (False, True):
        got = resolve_for_tp(get_config(arch, smoke=smoke), tp)
        want = jresolve_for_tp(jget_config(arch, smoke=smoke), tp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, smoke, tp)
        if got.n_heads:
            assert got.n_heads % tp == 0 and got.n_heads % got.n_kv_heads == 0
        assert got.d_ff % tp == 0


def test_resolve_for_tp_shapes_of_this_slice():
    """The per-rank shapes the chip runs: llama3-8b/1b at tp 2 and 3 and
    qwen2.5-14b at tp 3 (G 5)."""
    def per_rank(name, tp):
        c = resolve_for_tp(get_config(name), tp)
        return c.n_heads // tp, c.n_kv_heads, c.d_ff // tp

    assert per_rank("llama3-8b", 2) == (16, 8, 7168)
    assert per_rank("llama3-8b", 3) == (12, 9, 4779)
    assert per_rank("llama3-1b", 3) == (12, 9, 2731)
    assert per_rank("qwen2.5-14b", 3) == (15, 9, 4608)
    assert resolve_for_tp(get_config("llama3-70b"), 3).n_kv_heads == 8  # the tie keeps them


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


FAKE_CASES = [  # the reference's own (tests/test_sharding.py:19-45)
    ({"data": 4, "model": 8}, ("embed", "ff"), (64, 128)),
    ({"data": 4, "model": 8}, ("embed", "ff"), (63, 128)),
    ({"data": 4, "model": 8}, ("heads", "head_dim"), (6, 128)),
    ({"data": 4, "model": 8}, ("ff", "vocab"), (128, 256)),
    ({"pod": 2, "data": 4, "model": 8}, ("batch", "seq"), (32, 128)),
    ({"pod": 2, "data": 4, "model": 8}, ("batch", "seq"), (2, 128)),
]


@pytest.mark.parametrize("mesh,axes,shape", FAKE_CASES)
def test_spec_for_is_the_reference_on_its_fake_meshes(mesh, axes, shape):
    assert spec_for(mesh, axes, shape) == tuple(jspec_for(_FakeMesh(mesh), axes, shape))


def test_rules_are_the_reference_rules():
    assert DEFAULT_RULES == JDEFAULT_RULES


_AXES = st.sampled_from(sorted(k for k in JDEFAULT_RULES if k is not None) + [None])


@settings(max_examples=200, deadline=None)
@given(axes=st.lists(_AXES, min_size=1, max_size=4),
       dims=st.lists(st.integers(1, 97), min_size=4, max_size=4),
       sizes=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8]), min_size=3, max_size=3),
       present=st.lists(st.booleans(), min_size=3, max_size=3))
def test_spec_for_is_the_reference_on_drawn_meshes(axes, dims, sizes, present):
    mesh = {n: s for n, s, keep in zip(("pod", "data", "model"), sizes, present) if keep}
    shape = tuple(dims[:len(axes)])
    assert spec_for(mesh, axes, shape) == tuple(jspec_for(_FakeMesh(mesh), axes, shape))


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-coder-33b", "minicpm3-4b",
                                  "zamba2-2.7b", "rwkv6-7b"])
def test_pad_params_is_the_reference_and_computes_the_unpadded_model(arch):
    """The reference's own equivalence test (tp 3, smoke), run through the
    port: the padded tree bit for bit, the padded forward at 2e-4 (zamba2:
    its shared block's 4 heads to 6 and d_ff 128 to 129; rwkv6: its
    channel-mix ff 128 to 129; the mamba2 and time-mix tensors as they
    were)."""
    jcfg = jget_config(arch, smoke=True)
    jcfg_p = jresolve_for_tp(jcfg, 3)
    m, mp = jmake_model(jcfg), jmake_model(jcfg_p)
    jparams = m.init(jax.random.PRNGKey(0))
    want = unbox(jpad_params(jcfg, jcfg_p, jparams, mp.init(jax.random.PRNGKey(1))))
    cfg, cfg_p = port_config(jcfg), port_config(jcfg_p)
    got = pad_params(cfg, cfg_p, params_from_numpy(cfg, unbox(jparams), "cpu"))
    ref = dict(params_from_numpy(cfg_p, want, "cpu").named_parameters())
    for name, t in got.named_parameters():
        assert torch.equal(t, ref[name]), name
    toks = (np.arange(20, dtype=np.int32).reshape(2, 10) * 11 + 5) % cfg.vocab_size
    a = np.asarray(m.forward_train(jparams, tokens=jnp.asarray(toks)))
    b = make_model(cfg_p, "cpu").forward_train(got, tokens=toks)
    np.testing.assert_allclose(b.numpy(), a, atol=2e-4, rtol=2e-4)
    for name, t in got.named_parameters():  # unpad_tensor undoes it
        small = dict(params_from_numpy(cfg, unbox(jparams), "cpu").named_parameters())[name]
        assert torch.equal(unpad_tensor(cfg, cfg_p, *param_where(name), t), small), name


LAYOUTS = [(4, 2, 2), (6, 2, 3), (12, 4, 3), (72, 8, 3), (45, 9, 3), (32, 8, 2), (6, 6, 3),
           (48, 1, 3), (16, 16, 4)]


@pytest.mark.parametrize("hq,hkv,world", LAYOUTS)
def test_attn_layout_covers_every_head_once_in_uniform_groups(hq, hkv, world):
    g = hq // hkv
    owned = []
    for rank in range(world):
        q_src, kv_src = attn_layout(hq, hkv, rank, world)
        assert len(q_src) == g * len(kv_src)  # the kernels' uniform grouping, G = g
        for slot, q in enumerate(q_src):
            if q >= 0:
                assert q // g == kv_src[slot // g] and q % g == slot % g
                owned.append(q)
        if hkv % world == 0:  # the contiguous split: no zero head
            assert -1 not in q_src and len(kv_src) == hkv // world
    assert sorted(owned) == list(range(hq))


def test_uneven_groups_layout_of_twelve_by_four_at_three():
    """Rank 0 owns q 0-3, which read kv 0, 0, 0, 1: it keeps kv 0 and 1 and
    pads q to two whole groups."""
    assert attn_layout(12, 4, 0, 3) == ((0, 1, 2, 3, -1, -1), (0, 1))
    assert attn_layout(12, 4, 1, 3) == ((-1, 4, 5, 6, 7, -1), (1, 2))
    assert attn_layout(12, 4, 2, 3) == ((-1, -1, 8, 9, 10, 11), (2, 3))


@pytest.mark.parametrize("arch,world,form", [("qwen2.5-14b", 2, "tp"), ("qwen2.5-14b", 3, "tp"),
                                             ("deepseek-moe-16b", 2, "ep"),
                                             ("mixtral-8x22b", 3, "tp")])
def test_shards_are_contiguous_aligned_and_join_back(arch, world, form):
    cfg = get_config(arch, smoke=True)
    full = make_model(cfg, "cpu").init(0)
    shards = [Shard(cfg, r, world, form).params(full) for r in range(world)]
    for s in shards:
        for name, t in s.named_parameters():
            assert t.is_contiguous() and t.data_ptr() % 16 == 0, name
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), name
    back = dict(unshard_params(cfg, shards, form).named_parameters())
    for name, t in full.named_parameters():
        assert torch.equal(back[name], t), name


@pytest.mark.parametrize("arch,world,ff", [("llama3-8b", 2, 7168), ("llama3-8b", 3, 4784),
                                           ("llama3-1b", 3, 2736), ("llama3-70b", 3, 9560),
                                           ("qwen2.5-14b", 3, 4608)])
def test_a_ranks_mlp_width_is_its_share_padded_to_eight(arch, world, ff):
    """The share of the padded d_ff (4779, 2731, 9558 at tp 3) rounded up
    to a multiple of 8, so that fused_swiglu streams 16-byte rows; the
    rank's vocabulary is its share where the ranks divide it."""
    cfg = get_config(arch)
    for r in range(world):
        local = Shard(cfg, r, world).local_cfg
        assert local.d_ff == ff
        V = cfg.vocab_size
        assert local.vocab_size == (V // world if V % world == 0 else V)


def test_the_padding_of_a_ranks_mlp_share_is_zero_and_joins_away():
    cfg = get_config("llama3-8b", smoke=True)  # d_ff 128 -> 129 at tp 3: shares 43 -> 48
    full = make_model(cfg, "cpu").init(0)
    shards = [Shard(cfg, r, 3).params(full) for r in range(3)]
    for s in shards:
        mlp = s.layers[0].mlp
        assert mlp["wg"].shape[1] == mlp["wu"].shape[1] == mlp["wd"].shape[0] == 48
        assert not mlp["wg"][:, 43:].any() and not mlp["wu"][:, 43:].any()
        assert not mlp["wd"][43:].any() and mlp["wd"][:43].any()
    back = dict(unshard_params(cfg, shards).named_parameters())
    for name, t in full.named_parameters():
        assert torch.equal(back[name], t), name


def test_run_ranks_runs_on_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks("repro_torch.parallel.workers:foreign_modules", 2, workdir=tmp_path)
    assert not list(tmp_path.glob("rank*.log"))  # raised before any rank started


def test_reshard_params_from_two_ranks_to_three_is_direct_slicing():
    cfg = get_config("qwen2.5-14b", smoke=True)
    full = make_model(cfg, "cpu").init(0)
    two = [Shard(cfg, r, 2).params(full) for r in range(2)]
    for r in range(3):
        got = dict(reshard_params(cfg, two, r, 3).named_parameters())
        for name, t in Shard(cfg, r, 3).params(full).named_parameters():
            assert torch.equal(got[name], t), (r, name)


def test_sharded_init_keeps_the_whole_models_draws():
    """``Model.init`` under a group draws the unpadded model and keeps each
    tensor's padded shard: the same as sharding the single-device init."""
    cfg = get_config("llama3-1b", smoke=True)
    whole = make_model(cfg, "cpu").init(5)
    for r in range(3):
        group = _fake_group(r, 3)
        model = make_model(cfg, "cpu", group)
        got = dict(model.init(5).named_parameters())
        for name, t in shard_params(cfg, whole, group).named_parameters():
            assert torch.equal(got[name], t), name


def _fake_group(rank, world):
    return TPGroup(pg=None, rank=rank, world=world, device=torch.device("cpu"),
                   backend="gloo", ranks=tuple(range(world)))


@pytest.mark.parametrize("arch", PORTED)
def test_every_config_builds_under_groups_of_two_and_three(arch):
    """Each rank's ``Model.init`` keeps the same draws as sharding the whole
    model, and the ranks' shards join back to it bit for bit."""
    cfg = get_config(arch, smoke=True)
    whole = make_model(cfg, "cpu").init(3)
    for world in (2, 3):
        shards = [make_model(cfg, "cpu", _fake_group(r, world)).init(3) for r in range(world)]
        for r, got in enumerate(shards):
            want = dict(Shard(cfg, r, world).params(whole).named_parameters())
            for name, t in got.named_parameters():
                assert torch.equal(t, want[name]), (world, r, name)
        back = dict(unshard_params(cfg, shards).named_parameters())
        for name, t in whole.named_parameters():
            assert torch.equal(back[name], t), (world, name)


# (arch, world) -> per rank: (Hq, Hkv, recurrent heads, ff) of the smoke config
FAMILY_SHAPES = {
    ("minicpm3-4b", 2): [(2, 2, 0, 64)] * 2, ("minicpm3-4b", 3): [(2, 2, 0, 48)] * 3,
    ("zamba2-2.7b", 2): [(2, 2, 4, 64)] * 2, ("zamba2-2.7b", 3): [(2, 2, 0, 48)] * 3,
    ("rwkv6-7b", 2): [(0, 0, 2, 64)] * 2, ("rwkv6-7b", 3): [(0, 0, 0, 48)] * 3,
    ("llama-3.2-vision-90b", 2): [(2, 1, 0, 64)] * 2,
    ("llama-3.2-vision-90b", 3): [(3, 1, 0, 48), (6, 2, 0, 48), (3, 1, 0, 48)],
}


@pytest.mark.parametrize("world", (2, 3))
@pytest.mark.parametrize("arch", ["minicpm3-4b", "zamba2-2.7b", "rwkv6-7b",
                                  "llama-3.2-vision-90b"])
def test_every_family_builds_under_a_group_at_its_per_rank_shapes(arch, world):
    """A rank's model of each family: its head counts, recurrent heads and
    ff width, and the shapes of its tensors (zamba2's mamba2 ``w_in`` holds
    its z, x and dt columns and every BC column; rwkv6's ``cm_r`` stays
    whole); and ``make_train_step`` returns a step on each rank's model
    (tensor-parallel training, ``tests/test_torch_tp_train.py``)."""
    from repro_torch.launch.steps import make_train_step

    cfg = get_config(arch, smoke=True)
    for r in range(world):
        model = make_model(cfg, "cpu", _fake_group(r, world))
        c = model.run_cfg
        assert (c.n_heads, c.n_kv_heads, c.ssm_heads, c.d_ff) == FAMILY_SHAPES[arch, world][r]
        assert c.d_model == cfg.d_model  # the residual stream is whole on every rank
        params = model.init(0)
        if arch == "zamba2-2.7b":  # d_in 128 of 8 heads; BC 2·16; the rank's 4 heads at tp 2
            h = c.ssm_heads or 8
            assert params.layers[0].mamba["w_in"].shape == (64, 2 * 16 * h + 32 + h)
            assert params.layers[0].mamba["out_proj"].shape == (16 * h, 64)
        if arch == "rwkv6-7b":
            tm = params.layers[0].tm
            assert tm["w_rkvg"].shape == (4, 64, 16 * (c.ssm_heads or 4))
            assert tm["cm_r"].shape == (64, 64) and tm["cm_k"].shape == (64, c.d_ff)
        assert callable(make_train_step(c, model))


def test_two_nccl_ranks_on_one_card_raise_naming_gloo():
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", ["host/GPU-a", "host/GPU-a"])
    check_backend("nccl", ["host/GPU-a", "host/GPU-b"])
    check_backend("gloo", ["host/GPU-a", "host/GPU-a"])


def test_a_split_target_and_draft_group_raises_naming_13c():
    cfg = get_config("llama3-1b", smoke=True)
    T = make_model(cfg, "cpu", _fake_group(0, 2))
    D_split = make_model(cfg, "cpu", TPGroup(pg=None, rank=0, world=2,
                                             device=torch.device("cpu"), backend="gloo",
                                             ranks=(2, 3)))
    with pytest.raises(ValueError, match="one process per rank"):
        SpecEngine(T, D_split, SpecConfig(), 64, 64)
    with pytest.raises(ValueError, match="one process per rank"):
        SpecEngine(T, make_model(cfg, "cpu"), SpecConfig(), 64, 64)
    SpecEngine(T, make_model(cfg, "cpu", _fake_group(0, 2)), SpecConfig(), 64, 64)


@pytest.mark.parametrize("N", [43, 2731 // 8, 6])
def test_fused_swiglu_takes_any_width(N):
    """Ragged per-rank widths (d_ff / tp of a padded d_ff, e.g. 4779 and
    2731 on the card): the wrapper's plain version against the reference's."""
    from repro.kernels.ref import fused_swiglu_ref as jfused_swiglu_ref
    from repro_torch.kernels import ops

    rng = np.random.default_rng(N)
    x, wg, wu = (rng.normal(size=s).astype(np.float32) for s in ((3, 32), (32, N), (32, N)))
    got = ops.fused_swiglu(*map(torch.tensor, (x, wg, wu)))
    want = np.asarray(jfused_swiglu_ref(*map(jnp.asarray, (x, wg, wu))))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
