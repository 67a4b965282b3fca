"""Worker of the port's two-process ``gloo`` test
(``tests/test_torch_port_parallel.py::test_two_process_gloo_training``).

Launched twice with torchrun's ``env://`` variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): each
process joins the group through ``distributed_init``, runs the three
fitters under the group's mesh (:func:`run_all`), gathers a small metric
tree in rank order, and writes its histories, final weights and the files
of its own model directories for the parent to compare. The parent calls
:func:`run_all` in process for the one-process runs.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

F, Z, H = 33, 4, (8,)


def frames(n, seed, labels=True):
    """Unit-scale rows (|N(0, 1)| + 0.1) and random binary labels: every
    process builds the same arrays, as hosts read one shared filesystem."""
    from dvae_tpu_torch.data.datasets import FrameDataset

    rng = np.random.default_rng(seed)
    x = (np.abs(rng.standard_normal((n, F))) + 0.1).astype(np.float32)
    y = (rng.uniform(size=(n, 1)) > 0.5).astype(np.float32)
    return FrameDataset.from_arrays(x, y if labels else None)


def utterances(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(3000, 7000))
        w = (0.3 * rng.standard_normal(m)).astype(np.float32)
        out.append((w, (rng.uniform(size=m // 256 + 1) > 0.5).astype(np.float32)))
    return out


def run_all(vae_mesh, seq_mesh, out_dir):
    """fit_vae at K = 2 (69 train rows in batches of 16: four groupable
    batches, then a ragged 5 that the mesh wrap-pads; a validation batch of
    one that runs whole), fit_adversarial, and fit_sequence with a ragged
    trailing batch of one utterance (a fully masked pad row on the second
    process). Returns {name: (history, final state_dict)}."""
    from dvae_tpu_torch.models import VAE, DisentangledVAE, LSTMVad
    from dvae_tpu_torch.ops.stft import StftConfig
    from dvae_tpu_torch.train.loop import LoopConfig, fit_adversarial, fit_vae
    from dvae_tpu_torch.train.sequence import (
        batch_utterances,
        fit_sequence,
        make_lstm_vad_eval,
        make_lstm_vad_step,
    )
    from dvae_tpu_torch.train.steps import adam

    out_dir = pathlib.Path(out_dir)
    res = {}
    cfg = LoopConfig(batch_size=16, end_epoch=3, log_interval=1, learning_rate=1e-3,
                     steps_per_dispatch=2)
    model = VAE(F, Z, H)
    _, hist = fit_vae(model, frames(69, 0, labels=False), frames(33, 1, labels=False),
                      out_dir / "vae", "M1", cfg=cfg, mesh=vae_mesh, device="cpu")
    res["fit_vae"] = (hist, model.state_dict())

    model = DisentangledVAE(F, 1, Z, H)
    _, hist = fit_adversarial(model, frames(45, 2), frames(16, 3), out_dir / "adv", "M2",
                              1.0, 1.0, 1.0, cfg=LoopConfig(batch_size=16, end_epoch=3,
                                                            learning_rate=1e-3),
                              mesh=vae_mesh, device="cpu")
    res["fit_adversarial"] = (hist, model.state_dict())

    stft = StftConfig(center=True)
    model = LSTMVad(513, 8, 1, generator=torch.Generator().manual_seed(0))
    opt = adam(model.parameters(), 1e-3)
    hist = fit_sequence(
        model, opt, make_lstm_vad_step(model, opt, mesh=seq_mesh),
        make_lstm_vad_eval(model, mesh=seq_mesh), utterances(7, 4), utterances(3, 5),
        lambda ds, idx: batch_utterances(ds, idx, stft, device="cpu"), out_dir / "seq",
        prefix="VAD", end_epoch=3, batch_size=3, mesh=seq_mesh, log=lambda m: None)
    res["fit_sequence"] = (hist, model.state_dict())
    return res


def files(d):
    d = pathlib.Path(d)
    return sorted(p.name for p in d.iterdir()) if d.is_dir() else []


def main():
    out_dir = pathlib.Path(sys.argv[1])
    torch.set_num_threads(1)
    from dvae_tpu_torch.parallel import distributed_init, gather_metrics, make_mesh

    assert distributed_init("cpu") is True, "distributed_init must report a joined group"
    assert distributed_init("cpu") is True  # idempotent
    mesh = make_mesh(device="cpu")
    assert mesh.size == 2 and mesh.world == 2
    rank = mesh.rank
    mine = out_dir / f"rank{rank}"
    res = run_all(mesh, mesh, mine)
    mine.mkdir(parents=True, exist_ok=True)
    gathered = gather_metrics({"rank": np.float32(rank), "tag": np.float32(10 * (rank + 1))})
    for name, (_, state) in res.items():
        torch.save(state, mine / f"{name}.pt")
    (out_dir / f"result_{rank}.json").write_text(json.dumps({
        "history": {name: hist for name, (hist, _) in res.items()},
        "gathered_rank": gathered["rank"].tolist(),
        "gathered_tag": gathered["tag"].tolist(),
        "files": {name: files(mine / sub) for name, sub in
                  (("fit_vae", "vae"), ("fit_adversarial", "adv"), ("fit_sequence", "seq"))},
    }))


if __name__ == "__main__":
    main()
