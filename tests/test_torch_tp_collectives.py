"""Collective matmul, the int8 gradient mean, sharded batches and
data-parallel training over gloo ranks on the CPU.

``matmul_allreduce`` and ``matmul_ag_pipelined`` against ``x @ w`` at world
sizes 2 and 3; ``pod_allreduce_compressed`` against the reference's
``compress_int8``/``decompress_int8`` applied per rank and averaged;
``sharded_batches`` against the rows of the reference dataset's batches;
two train steps with ``grad_compress_pod`` at world 2 against one process
that applies the same averaged int8 gradient.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JSyntheticLMDataset
from repro.optim import compress_int8 as jcompress_int8
from repro.optim.compression import decompress_int8 as jdecompress_int8
from repro_torch.configs import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.api import make_model
from repro_torch.optim import adamw_init, adamw_update, compress_int8, warmup_cosine
from repro_torch.optim.compression import mean_dequantized
from repro_torch.parallel.spawn import run_ranks

SPAWN_S = 120
TINY = ModelConfig(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                   vocab_size=64)
DATA = dict(vocab_size=64, seq_len=16, global_batch=4, seed=3)
LR = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
STEPS = 2


def _xw(world):
    rng = np.random.default_rng(world)
    return (rng.normal(size=(5, 4 * world)).astype(np.float32),
            rng.normal(size=(4 * world, 6 * world)).astype(np.float32))


def _grads(world):
    rng = np.random.default_rng(10 + world)
    return [(rng.normal(size=(7, 9)) * 10 ** rng.uniform(-4, 0)).astype(np.float32)
            for _ in range(world)]


def _tiny_tree():
    params = make_model(TINY, "cpu").init(0)
    tree = {"embed": params.embed.numpy(), "final_norm": params.final_norm.numpy(),
            "lm_head": params.lm_head.numpy(), "groups": []}
    keys = [dict(p.named_parameters()) for p in params.layers]
    unit = {"ln1": np.stack([k["ln1"].numpy() for k in keys]),
            "ln2": np.stack([k["ln2"].numpy() for k in keys]),
            "attn": {n: np.stack([k[f"attn.{n}"].numpy() for k in keys])
                     for n in ("wq", "wk", "wv", "wo")},
            "mlp": {n: np.stack([k[f"mlp.{n}"].numpy() for k in keys]) for n in ("wg", "wu", "wd")}}
    tree["groups"].append((unit,))
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world in (2, 3):
        calls = [("collectives", _xw(world)), ("compressed_mean", (_grads(world),)),
                 ("batches", (DataConfig(**DATA) if world == 2 else
                              DataConfig(**dict(DATA, global_batch=6)), 5, 3))]
        if world == 2:
            calls.append(("train", (TINY, _tiny_tree(), DataConfig(**DATA), STEPS, LR)))
        out[world] = run_ranks("repro_torch.parallel.workers:several", world, (calls,),
                               workdir=tmp_path_factory.mktemp(f"coll{world}"),
                               device="cpu", timeout_s=SPAWN_S)
    return out


@pytest.mark.parametrize("schedule", ["allreduce", "ag_pipelined"])
@pytest.mark.parametrize("world", [2, 3])
def test_collective_matmul_is_the_product(runs, world, schedule):
    x, w = _xw(world)
    for r, res in enumerate(runs[world]):
        np.testing.assert_allclose(res[0][schedule], x @ w, atol=1e-5, rtol=1e-5,
                                   err_msg=f"rank {r}")
    if schedule == "allreduce":  # the gathered halves: the same bits everywhere
        assert all(np.array_equal(res[0][schedule], runs[world][0][0][schedule])
                   for res in runs[world])


@pytest.mark.parametrize("world", [2, 3])
def test_pod_allreduce_compressed_is_the_reference_mean(runs, world):
    grads = _grads(world)
    want = sum(np.asarray(jdecompress_int8(*jcompress_int8(jnp.asarray(g)))) for g in grads)
    want = want / world
    for res in runs[world]:
        np.testing.assert_allclose(res[1], want, atol=1e-7, rtol=1e-6)
        assert np.array_equal(res[1], runs[world][0][1])


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_batches_are_the_reference_rows(runs, world):
    cfg = dict(DATA, global_batch=4 if world == 2 else 6)
    ref = JSyntheticLMDataset(JDataConfig(**cfg))
    n = cfg["global_batch"] // world
    for r, res in enumerate(runs[world]):
        assert [s for s, _ in res[2]] == [5, 6, 7]
        for step, rows in res[2]:
            assert np.array_equal(rows, ref.batch(step)["tokens"][r * n:(r + 1) * n])


def test_data_parallel_steps_with_the_int8_mean_are_one_process_steps(runs):
    """Each rank's gradient on its rows, int8 round trip, averaged: the
    same update as the two ranks made, and the same on both."""
    model = make_model(TINY, "cpu")
    params = params_from_numpy(TINY, _tiny_tree(), "cpu").requires_grad_(True)
    opt = adamw_init(params)
    ds = SyntheticLMDataset(DataConfig(**DATA))
    losses = []
    for step in range(STEPS):
        tokens = ds.batch(step)["tokens"]
        grads, rank_losses = [], []
        for r in range(2):
            loss, g = loss_and_grads(model, params, {"tokens": tokens[2 * r:2 * r + 2]})
            grads.append(g)
            rank_losses.append(float(loss))
        mean = []
        for per_rank in zip(*grads):
            qs, ss = zip(*(compress_int8(g) for g in per_rank))
            mean.append(mean_dequantized(torch.stack(qs), torch.stack(ss)))
        lr = warmup_cosine(opt.step, **LR)
        params, opt = adamw_update(mean, opt, params, lr)
        losses.append(rank_losses)
    want = {k: v.detach().numpy() for k, v in params.named_parameters()}
    ranks = [res[3] for res in runs[2]]
    for r, res in enumerate(ranks):
        assert res["losses"] == [rl[r] for rl in losses]
        for k, v in want.items():
            np.testing.assert_array_equal(res["params"][k], v, err_msg=f"rank {r} {k}")


def test_a_failing_rank_fails_the_spawn_instead_of_hanging_it(tmp_path):
    """Rank 1 has no gradient (an IndexError) while rank 0 waits in the
    all-gather: the spawn raises with rank 1's error, rank 0 killed."""
    with pytest.raises(RuntimeError, match="IndexError"):
        run_ranks("repro_torch.parallel.workers:compressed_mean", 2, (_grads(1),),
                  workdir=tmp_path, device="cpu", timeout_s=SPAWN_S)


def test_a_spawn_past_its_time_limit_is_killed(tmp_path):
    with pytest.raises(TimeoutError, match="ran past"):
        run_ranks("repro_torch.parallel.workers:compressed_mean", 2, (_grads(2),),
                  workdir=tmp_path, device="cpu", timeout_s=0.2)
