"""``launch/train.py --mesh-model`` under torchrun on the CPU: 4 gloo ranks,
2 data x 2 model, on llama3-1b's smoke config.

The run's losses are the single-process run's on the same global batches,
and its per-rank checkpoints joined (``Shard.join``) are the single-process
parameters; only rank 0 logs.  With its newest checkpoint taken away the
run resumes from the one before and ends on the same bits, on every model
rank.  A checkpoint made under one layout does not restore under another.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro_torch.ckpt.manager import check_layout
from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.models.transformer import param_where
from repro_torch.parallel.shard import Shard

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = dict(steps=6, batch=4, seq=16, ckpt_every=2)  # checkpoints at steps 2, 4 and 5 (the end)
STEP_TOL = 5e-5  # the logged losses have 4 decimals


def _torchrun(ckpt, nproc=4, mesh_model=2):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(nproc), "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", "llama3-1b",
         "--mesh-model", str(mesh_model), "--steps", str(ARGS["steps"]), "--batch",
         str(ARGS["batch"]), "--seq", str(ARGS["seq"]), "--ckpt-every", str(ARGS["ckpt_every"]),
         "--log-every", "1", "--ckpt", str(ckpt)],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return res.stdout.splitlines()


def _leaves(path: pathlib.Path) -> list:
    n = len(list(path.glob("leaf_*.npy")))
    return [np.load(path / f"leaf_{i}.npy") for i in range(n)]


def test_train_cli_with_mesh_model_equals_one_process_and_resumes_bit_for_bit(tmp_path):
    cfg = get_config("llama3-1b", smoke=True)
    want = train(cfg, device="cpu", log=lambda *_: None, **{k: ARGS[k] for k in
                                                             ("steps", "batch", "seq")})
    ckpt = tmp_path / "ckpt"
    lines = _torchrun(ckpt)
    logged = [ln for ln in lines if ln.startswith("step ")]
    assert len(logged) == ARGS["steps"]  # rank 0 logs, the other three do not
    got = [float(ln.split()[3]) for ln in logged]
    np.testing.assert_allclose(got, want["losses"], atol=STEP_TOL)
    assert (ckpt / "LAYOUT.json").exists()
    assert sorted(p.name for p in ckpt.iterdir() if p.is_dir()) == ["model0", "model1"]

    # the checkpoints of step 5 of both model ranks, joined: the single-process params
    names = [n for n, _ in want["params"].named_parameters()]
    last = {r: _leaves(ckpt / f"model{r}" / "step_000000000005") for r in (0, 1)}
    sh = Shard(cfg, 0, 2)
    for i, (name, w) in enumerate(want["params"].named_parameters()):
        joined = sh.join(*param_where(name), [torch.from_numpy(last[r][i]) for r in (0, 1)])
        w = w.detach().numpy()
        np.testing.assert_allclose(joined.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    assert len(names) < len(last[0])  # the moments and masters follow the params

    # take the newest checkpoint away: the run resumes at step 5 from step 4 and writes
    # step 5's state again, bit for bit, on both model ranks
    for r in (0, 1):
        shutil.move(ckpt / f"model{r}" / "step_000000000005", tmp_path / f"kept{r}")
    lines = _torchrun(ckpt)
    assert "resumed from step 4" in lines and lines.count("resumed from step 4") == 1
    assert [ln.split("(")[0] for ln in lines if ln.startswith("step ")] == \
        [ln.split("(")[0] for ln in logged[5:]]  # the same loss, without the clock
    for r in (0, 1):
        again = _leaves(ckpt / f"model{r}" / "step_000000000005")
        assert len(again) == len(last[r])
        assert all(np.array_equal(a, b) for a, b in zip(again, _leaves(tmp_path / f"kept{r}")))

    # a single process does not take these checkpoints, nor a mesh of other width
    with pytest.raises(ValueError, match=r"world 4 with --mesh-model 2.*world 1 with "
                                         r"--mesh-model 1"):
        train(cfg, device="cpu", ckpt=str(ckpt), log=lambda *_: None, **ARGS)
    with pytest.raises(ValueError, match="world 4 with --mesh-model 2.*world 4 with "
                                         "--mesh-model 4"):
        check_layout(str(ckpt), (4, 4))


def test_a_single_process_checkpoint_does_not_restore_under_a_mesh(tmp_path):
    cfg = get_config("llama3-1b", smoke=True)
    train(cfg, device="cpu", ckpt=str(tmp_path), steps=2, batch=2, seq=8, log=lambda *_: None)
    check_layout(str(tmp_path), (1, 1))
    with pytest.raises(ValueError, match="world 1 with --mesh-model 1.*world 4 with "
                                         "--mesh-model 2"):
        check_layout(str(tmp_path), (4, 2))


def test_mesh_model_without_torchrun_raises():
    from repro_torch.launch.train import main

    with pytest.raises(SystemExit, match="torchrun"):
        main(["--device", "cpu", "--mesh-model", "2", "--steps", "1"])
    with pytest.raises(ValueError, match="needs a world"):
        train(get_config("llama3-1b", smoke=True), device="cpu", steps=1, mesh_model=2)


def test_the_nccl_train_tool_imports_neither_jax_nor_the_reference_and_needs_four_cards():
    """``tools/train_nccl.py`` runs on the card's machine, where there is no
    JAX: it imports none, and without four CUDA devices it exits 1 and
    prints no result."""
    import ast

    tool = ROOT / "tools" / "train_nccl.py"
    tree = ast.parse(tool.read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert "chip_smoke" in mods and not [m for m in mods if m.split(".")[0] in
                                         ("jax", "jaxlib", "repro")]
    if torch.cuda.device_count() >= 4:
        pytest.skip("four CUDA devices are present: the tool rightly runs on them")
    res = subprocess.run([sys.executable, str(tool)], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 1 and res.stdout == ""
    assert "needs 4 CUDA devices" in res.stderr
