"""The port's data parallelism (``dvae_tpu_torch/parallel/``) on the CPU.

The single-process contracts of ``tests/test_parallel.py`` (a no-op init,
``distribute_batch`` equal to ``shard_batch``, the loud ``--multihost``
failure, ``gather_metrics``' leading process axis); a real two-process
``gloo`` group (torchrun's ``env://`` variables, subprocesses of
``tests/_torch_parallel_worker.py``) whose three fitters equal the
one-process runs of the same mesh size (losses rtol 1e-5, parameters atol
2e-6, the contract of ``tests/test_torch_port_train_cond.py``) with rank 0
alone writing; and the port's ``Enhancer`` on a 4-shard CPU mesh against
the JAX ``Enhancer`` on ``make_mesh(4)``, frozen chain, shared NMF init.
"""

import argparse
import importlib.util
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dvae_tpu.enhance.mcem import McemConfig as JaxMcemConfig
from dvae_tpu.enhance.pipeline import Enhancer as JaxEnhancer
from dvae_tpu.enhance.pipeline import EnhancerConfig as JaxEnhancerConfig
from dvae_tpu.parallel import make_mesh as jax_make_mesh
from dvae_tpu_torch.cli import _family
from dvae_tpu_torch.enhance.mcem import McemConfig
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.parallel import (
    Mesh,
    distribute_batch,
    distributed_init,
    gather_metrics,
    global_batch_from_local,
    make_mesh,
    replicate,
    shard_batch,
)
from dvae_tpu_torch.parallel.distributed import TORCHRUN_ENV
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_pipeline import BUDGET, models, shared_nmf_init, wavs  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def no_torchrun(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)


def test_distributed_init_single_process_noop(no_torchrun):
    # nothing set: stays a single process, joins no group
    assert distributed_init("cpu") is False
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),) and mesh.size == 1 and mesh.group is None


def test_partial_torchrun_environment_raises(no_torchrun, monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed_init("cpu")
    assert not torch.distributed.is_initialized()


def test_global_batch_from_local_matches_shard_batch():
    mesh = make_mesh(4, device="cpu")
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    batch = {"x": x, "y": np.arange(16, dtype=np.int32)}
    g = global_batch_from_local(batch, mesh)
    s = shard_batch(batch, mesh)
    assert len(g["x"]) == len(s["x"]) == 4
    for a, b in zip(g["x"] + g["y"], s["x"] + s["y"]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(torch.cat(g["x"]).numpy(), x)
    np.testing.assert_array_equal(torch.cat(g["y"]).numpy(), batch["y"])


def test_distribute_batch_single_process_equals_shard_batch():
    mesh = make_mesh(4, device="cpu")
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    d = distribute_batch((x, x[:, 0]), mesh)
    s = shard_batch((x, x[:, 0]), mesh)
    for a, b in zip(d[0] + d[1], s[0] + s[1]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(torch.cat(d[0]).numpy(), x)
    # the multi-step (K, B, ...) stacks shard on dim 1, K whole on every shard
    xs = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
    blocks = distribute_batch(xs, mesh, batch_dim=1)
    assert [tuple(b.shape) for b in blocks] == [(2, 2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(blocks, 1).numpy(), xs)
    with pytest.raises(ValueError, match="not divisible by 4 shards"):
        shard_batch(np.zeros((6, 2)), mesh)


def test_make_mesh_rules(monkeypatch, no_torchrun):
    assert make_mesh(3, device="cpu").size == 3
    assert Mesh(["cpu", "cpu"]).device == torch.device("cpu")
    with pytest.raises(ValueError, match="one process per GPU"):
        Mesh(["cpu", "meta"]).device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="requested a 3-device mesh but only 2 devices"):
        make_mesh(3)
    # one process: replicate is a no-op on the module
    m = torch.nn.Linear(2, 2)
    before = m.weight.clone()
    assert replicate(m, make_mesh(2, device="cpu")) is m and torch.equal(m.weight, before)


def test_gather_metrics_single_process_shape():
    out = gather_metrics({"loss": np.float32(2.5), "n": np.int32(7),
                          "t": torch.tensor([1.0, 2.0])})
    assert out["loss"].shape == (1,)
    np.testing.assert_allclose(out["loss"][0], 2.5)
    assert out["n"][0] == 7
    assert out["t"].shape == (1, 2)


def test_multihost_flag_fails_loudly_without_cluster(no_torchrun):
    """--multihost with no torchrun group must error, not train an
    independent copy per process: as a process, and in process at world
    size 1 (one process joined alone)."""
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    r = subprocess.run([sys.executable, "-m", "dvae_tpu_torch.cli.training_m1", "--multihost",
                        "--end-epoch", "2", "--platform", "cpu", "--data-root", "/nonexistent"],
                       capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode != 0
    assert "--multihost was requested" in r.stderr and "torchrun" in r.stderr
    args = argparse.Namespace(data_parallel=True, multihost=False, platform="cpu")
    mesh = _family.trainer_mesh(args)
    assert mesh.size == 1 and mesh.group is None  # --data-parallel alone: world size 1


def _free_port() -> int:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_two(out_dir):
    """Two worker processes under one gloo group, retried on a fresh port
    when the probed one was taken before the group bound it."""
    for attempt in range(3):
        port = _free_port()
        procs = []
        for rank in (0, 1):
            env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
                   "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   "OMP_NUM_THREADS": "1"}
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_parallel_worker.py"),
                 str(out_dir)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        finally:
            for p in procs:  # a worker that died leaves its peer waiting
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 for p in procs):
            return
        if not (attempt < 2 and any("Address already in use" in e for _, e in outs)):
            break
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}\n{err[-4000:]}"


def _close(got, want, what):
    for g, w in zip(got, want, strict=True):
        assert g["epoch"] == w["epoch"]
        for part in ("train", "valid"):
            assert set(g[part]) == set(w[part]), what
            for k, v in w[part].items():
                np.testing.assert_allclose(g[part][k], v, rtol=1e-5, err_msg=f"{what} {k}")


def test_two_process_gloo_training(tmp_path):
    """A real two-process group: fit_vae at K = 2 with a wrap-padded ragged
    batch, fit_adversarial, fit_sequence with a fully masked pad row. Both
    ranks log the same histories, gather_metrics is in rank order, rank 0
    alone writes, and histories and weights equal the one-process runs of
    the same mesh size."""
    _launch_two(tmp_path)
    r = [json.loads((tmp_path / f"result_{k}.json").read_text()) for k in (0, 1)]
    assert r[0]["history"] == r[1]["history"]
    assert r[0]["gathered_rank"] == [0.0, 1.0] == r[1]["gathered_rank"]
    assert r[0]["gathered_tag"] == [10.0, 20.0] == r[1]["gathered_tag"]
    for name, written in r[0]["files"].items():
        assert sum(f.endswith(".opt.pt") for f in written) == 2, (name, written)
        assert r[1]["files"][name] == [], name  # rank 1 wrote nothing
    assert {"output_batch.log", "output_epoch.log"} <= set(r[0]["files"]["fit_vae"])

    spec = importlib.util.spec_from_file_location(
        "torch_parallel_worker", ROOT / "tests" / "_torch_parallel_worker.py")
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    # one process, the same mesh size (two shards on the CPU) for the frame
    # fitters, whose trailing batch the mesh wrap-pads; none for the
    # sequence fitter, whose padding rows are fully masked
    single = worker.run_all(Mesh(["cpu", "cpu"]), None, tmp_path / "single")
    for name, (hist, state) in single.items():
        _close(r[0]["history"][name], json.loads(json.dumps(hist)), name)
        for rank in (0, 1):
            got = torch.load(tmp_path / f"rank{rank}" / f"{name}.pt", weights_only=True)
            for k, v in state.items():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-6,
                                           err_msg=f"{name} rank {rank} {k}")


def test_enhancer_mesh_of_one_is_bitwise_and_shards_match(models):
    """A mesh of one shard is the unsharded run bitwise; four CPU shards
    give the frozen chain's unsharded result (the global NMF init sliced);
    live chains are finite, of the right shapes, and a mesh of size 1 is
    bitwise there too."""
    _, _, tm = models
    ws = wavs()
    for var_rw in (0.0, 0.01):
        cfg = EnhancerConfig(mcem=McemConfig(**{**BUDGET, "var_rw": var_rw},
                                             fast_decoder=False), wire_dtype="float32")
        one = Enhancer(tm, cfg, device="cpu").enhance_batch(ws, seed=3)
        m1 = Enhancer(tm, cfg, mesh=make_mesh(1, device="cpu")).enhance_batch(ws, seed=3)
        for (a, b), (c, d) in zip(one, m1, strict=True):
            assert np.array_equal(a, c) and np.array_equal(b, d)
        enh4 = Enhancer(tm, cfg, mesh=make_mesh(4, device="cpu"))
        four = enh4.enhance_batch(ws, seed=3)
        assert enh4.last_cost.shape == (BUDGET["niter"],) and np.isfinite(enh4.last_cost).all()
        for (a, _), (c, n), x in zip(one, four, ws, strict=True):
            assert c.shape == n.shape == x.shape and np.isfinite(c).all()
            if var_rw == 0.0:
                np.testing.assert_allclose(c, a, atol=1e-4 * (np.abs(a).max() + 1e-9))


@pytest.mark.parametrize("n_wavs", [4, 3], ids=["divisible", "padded"])
def test_enhancer_mesh_matches_jax_mesh(models, shared_nmf_init, n_wavs):
    """The port's Enhancer on a 4-shard CPU mesh against the JAX Enhancer
    on make_mesh(4), frozen chain, shared NMF init: a divisible batch and
    a batch of 3 padded to 4 with a silent utterance."""
    jm, params, tm = models
    ws = wavs()[:n_wavs]
    jcfg = JaxEnhancerConfig(mcem=JaxMcemConfig(**BUDGET, fast_stats=False, fast_decoder=False),
                             wire_dtype="float32")
    tcfg = EnhancerConfig(mcem=McemConfig(**BUDGET, fast_stats=False, fast_decoder=False),
                          wire_dtype="float32")
    jout = JaxEnhancer(jm, params, jcfg, mesh=jax_make_mesh(4)).enhance_batch(
        ws, key=jax.random.PRNGKey(0))
    tout = Enhancer(tm, tcfg, mesh=make_mesh(4, device="cpu")).enhance_batch(ws, seed=0)
    assert len(tout) == len(jout) == n_wavs
    for (js, jn), (ts, tn) in zip(jout, tout):
        peak = np.abs(js).max() + 1e-9
        np.testing.assert_allclose(ts, js, atol=1e-4 * peak)
        np.testing.assert_allclose(tn, jn, atol=1e-4 * peak)


def test_enhancer_refuses_a_group_mesh_and_an_absent_card(models, monkeypatch):
    _, _, tm = models
    mesh = make_mesh(2, device="cpu")
    monkeypatch.setattr(mesh, "group", object())
    with pytest.raises(ValueError, match="process group's mesh is the trainers'"):
        Enhancer(tm, mesh=mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Enhancer(tm, mesh=Mesh(["cuda", "cuda"]))

