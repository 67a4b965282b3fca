"""Epoch-driven frame-level training with reference-format logs and
checkpoints (port of ``dvae_tpu.train.loop`` on one device): ``fit_vae``
(M1, and M2 with ``conditional=True``), ``fit_semisup`` (M2v3) and
``fit_adversarial`` (M2-info and CVAE_v4).

Per-batch metrics go to ``output_batch.log`` every ``log_interval`` steps,
per-epoch train and validation lines to stdout and ``output_epoch.log``,
and one checkpoint per epoch named ``<prefix>_epoch_{e:03d}_vloss_{v:.2f}``
(see :mod:`dvae_tpu_torch.train.checkpoint`).

Every epoch's randomness is a pure function of ``(seed, epoch)``: the
shuffle is ``np.random.default_rng((seed, epoch))`` as in the JAX loop, and
the reparameterization noise comes from a ``torch.Generator`` seeded from
the same pair. A run resumed at ``start_epoch`` therefore replays the
uninterrupted run exactly.

Under a :class:`~dvae_tpu_torch.parallel.Mesh` (``mesh=``) each process
runs its contiguous rows of every global batch, as JAX's loop shards the
batch over the ``data`` axis: a trailing batch that does not divide the
mesh is wrap-padded first (``_pad_shardable``: rows repeated, never
zeros); the replicas start from rank 0's weights; each step draws the
sampling noise of the whole global batch from the epoch's generator and
keeps its own rows, so every process's generator stays in step with the
one-process run's; the gradients are all-reduced (summed, then divided by
the world size) before each optimizer steps, and the metrics likewise.
A run at world size N therefore equals the one-process run of the same
mesh size up to the all-reduce's rounding. Only rank 0 writes logs and
checkpoints.

``steps_per_dispatch = K > 1`` runs K same-shape batches per dispatch
through :class:`~dvae_tpu_torch.train.steps.MultiStep`, one CUDA graph
replay on the card, as JAX's buffered flush does: a ragged trailing batch
runs alone through the one-step path. The batches and the noise are those
of K = 1, so on the CPU a K-step run gives K = 1's weights bitwise; on the
card the optimizers are capturable, whose update rounds differently.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch

from dvae_tpu_torch.data.datasets import index_batches
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.models.blocks import init_xavier_
from dvae_tpu_torch.parallel.distributed import allreduce_sum, grad_allreduce
from dvae_tpu_torch.parallel.mesh import replicate
from dvae_tpu_torch.train import checkpoint as ckpt
from dvae_tpu_torch.train.steps import (
    MultiStep,
    adam,
    init_adversarial_state,
    make_adversarial_eval_step,
    make_adversarial_step,
    make_eval_step,
    make_semisup_eval_step,
    make_semisup_step,
    make_train_step,
)


@dataclasses.dataclass
class LoopConfig:
    batch_size: int = 128
    learning_rate: float = 1e-4
    start_epoch: int = 1
    end_epoch: int = 500
    log_interval: int = 250
    seed: int = 0
    eps: float = 1e-8
    std_norm: bool = False
    drop_last: bool = False
    # K optimizer steps per dispatch: a CUDA graph over K steps on the card,
    # K eager steps on the CPU; the same batches and noise as K = 1
    steps_per_dispatch: int = 1
    # upload each split (rows and labels) to the device once and gather each
    # batch by index there, instead of copying every batch from the host:
    # the same batches, the same noise, the same math
    device_data: bool = False


class _Logger:
    """Reference-format batch and epoch logs. Under a process group only
    rank 0 writes and prints (``enabled``): every rank logs the same
    numbers, and N appenders to one shared log would interleave."""

    def __init__(self, model_dir, append: bool = False, enabled: bool = True):
        self.dir = pathlib.Path(model_dir)
        self.enabled = enabled
        if not enabled:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        if not append:
            (self.dir / "output_batch.log").write_text("")
            (self.dir / "output_epoch.log").write_text("")

    def batch(self, msg):
        if not self.enabled:
            return
        with open(self.dir / "output_batch.log", "a") as f:
            print(msg, file=f)

    def epoch(self, msg):
        if not self.enabled:
            return
        print(msg)
        with open(self.dir / "output_epoch.log", "a") as f:
            print(msg, file=f)


def _resume_checkpoint(model_dir, prefix: str, start_epoch: int):
    """Path of the epoch-(start_epoch - 1) checkpoint, or None when
    ``start_epoch <= 1``. Raises when it is missing: silently restarting
    from scratch would discard the requested resume."""
    if start_epoch <= 1:
        return None
    # several files for one epoch (a crashed resume re-ran it): the newest
    hits = sorted(ckpt.checkpoints(model_dir, f"{prefix}_epoch_{start_epoch - 1:03d}_vloss_*.pt"),
                  key=lambda q: q.stat().st_mtime)
    if not hits:
        raise FileNotFoundError(
            f"start_epoch={start_epoch} but no epoch-{start_epoch - 1} checkpoint "
            f"under {model_dir}")
    return hits[-1]


def _fmt(metrics: dict) -> str:
    return "    ".join(f"{k}: {float(v):.3f}" for k, v in metrics.items())


def epoch_generator(seed: int, epoch: int, device, generator=None) -> torch.Generator:
    """The sample-noise generator of one epoch, a pure function of
    ``(seed, epoch)`` (the tag keeps it apart from the init generator):
    ``generator`` re-seeded in place when given (a CUDA graph registered
    with it sees the new seed), else a new one."""
    state = np.random.SeedSequence([seed, 0x10F, epoch]).generate_state(1)[0]
    gen = torch.Generator(device=device) if generator is None else generator
    return gen.manual_seed(int(state))


class _HostFeed:
    """Batches of the host dataset (in memory or streamed from its h5): one
    batch copied to the device as (x (B, F), y (B, Yd) or None), or K
    batches as one (K, B, ...) stack. On the card a stack is built in pinned
    memory, two buffers in turn, each refilled only once the dispatch that
    read it has finished."""

    def __init__(self, ds, device, labels: bool):
        self.ds, self.device, self.labels = ds, device, labels
        self.data = None
        self._pinned, self._turn, self._last = {}, 0, None

    def batches(self, batch_size, rng=None, drop_last=False):
        return self.ds.batches(batch_size, rng, drop_last)

    @staticmethod
    def size(item) -> int:
        return item[0].shape[0]

    def one(self, item, rows=None):
        """The batch on the device; ``rows`` (indices into it) keeps those
        rows only, in their order."""
        x, y = item if rows is None else (item[0][rows], None if item[1] is None
                                          else item[1][rows])
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device) if self.labels else None)

    def stack(self, items, rows=slice(None)):
        parts = [[it[0][rows] for it in items]] + (
            [[it[1][rows] for it in items]] if self.labels else [])
        if self.device.type != "cuda":
            out = [torch.from_numpy(np.stack(a)) for a in parts]
        else:
            key = tuple((len(a),) + a[0].shape for a in parts)
            slot = self._pinned.setdefault(key, [None, None])
            j = self._turn = 1 - self._turn
            if slot[j] is None:
                slot[j] = ([torch.empty(k, pin_memory=True) for k in key], None)
            out, done = slot[j]
            if done is not None:
                done.synchronize()
            for buf, a in zip(out, parts):
                np.stack(a, out=buf.numpy())
            self._last = (slot, j)
        return out[0], out[1] if self.labels else None

    def sent(self) -> None:
        """Mark the stack of the last :meth:`stack` as read once the work
        enqueued so far has run."""
        if self._last is not None:
            slot, j = self._last
            done = torch.cuda.Event()
            done.record()
            slot[j] = (slot[j][0], done)
            self._last = None


class _DeviceFeed:
    """The same batches gathered from one upload of the split, labels by the
    same index batches. The epoch's row order goes up once, so a step waits
    on no copy from the host; K batches are a (K, B) view of that order."""

    def __init__(self, ds, device, labels: bool):
        x_all, y_all = ds.arrays
        self.n = len(ds)
        self.data = (torch.from_numpy(x_all).to(device),
                     torch.from_numpy(y_all).to(device) if labels else None)
        self.device = device
        self._order = None

    def batches(self, batch_size, rng=None, drop_last=False):
        sels = list(index_batches(self.n, batch_size, rng, drop_last))
        if not sels:
            return
        self._order = torch.from_numpy(np.concatenate(sels)).to(self.device)
        start = 0
        for sel in sels:
            yield start, len(sel)
            start += len(sel)

    @staticmethod
    def size(item) -> int:
        return item[1]

    def one(self, item, rows=None):
        start, n = item
        idx = self._order[start:start + n]
        if rows is not None:
            idx = idx[torch.from_numpy(rows).to(self.device)]
        x_all, y_all = self.data
        return x_all.index_select(0, idx), None if y_all is None else y_all.index_select(0, idx)

    def stack(self, items, rows=slice(None)):
        return self._order.narrow(0, items[0][0], len(items) * items[0][1]).view(
            len(items), items[0][1])[:, rows], None

    def sent(self) -> None:
        pass


def _rows(feed):
    def batches(batch_size, rng=None, drop_last=False):
        for item in feed.batches(batch_size, rng, drop_last):
            yield feed.one(item)
    return batches


def _host_rows(ds, device, labels: bool = False):
    """Batches copied from the host dataset, as (x (B, F), y (B, Yd) or
    None) tensors on ``device``."""
    return _rows(_HostFeed(ds, device, labels))


def _device_rows(ds, device, labels: bool = False):
    """The same batches gathered from one upload of the split."""
    return _rows(_DeviceFeed(ds, device, labels))


def _optimizers(opt) -> list:
    return list(opt.values()) if isinstance(opt, dict) else [opt]


def _state_cpu(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _pad_shardable(n: int, mesh) -> np.ndarray:
    """This process's rows (indices into the batch) of a batch of ``n``
    rows wrap-padded so that it divides the mesh: rows repeated from the
    batch start, never zeros (x = 0 would put log 0 into the
    Itakura-Saito ELBO). The repeated rows weigh that one trailing batch a
    little more, as in the JAX loop."""
    order = np.arange(-(-n // mesh.size) * mesh.size) % n
    return order[_mine(len(order), mesh)]


def _mine(n: int, mesh) -> slice:
    """This process's contiguous rows of a global batch of ``n`` rows
    (``n`` divides the mesh)."""
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _sharded(fn, mesh, z_dim: int):
    """``fn`` (a step or evaluate taking ``(x, y, generator=,
    sample_eps=)``) on this process's rows of a global batch: it draws the
    reparameterization noise of the whole global batch (``world`` times
    its rows) from ``generator``, as the one-process run draws it, and
    passes its own rows as ``sample_eps``; the metrics come back averaged
    over the group."""
    world, rank = mesh.world, mesh.rank

    def call(x, y=None, generator=None, sample_eps=None):
        b = x.shape[0]
        if sample_eps is None:
            eps = torch.randn((b * world, z_dim), generator=generator, device=x.device)
            sample_eps = eps[rank * b:(rank + 1) * b]
        m = fn(x, y, sample_eps=sample_eps)
        if mesh.group is None:
            return m
        names = list(m)
        v = allreduce_sum(torch.stack([m[k] for k in names]), mesh) / world
        return dict(zip(names, v.unbind()))

    return call


def _run_epochs(model, opt, step, evaluate, train_ds, valid_ds, model_dir, prefix: str,
                cfg: LoopConfig, device, labels: bool, vloss_key: str, mesh=None):
    """The epoch loop of every fitter: the resume of ``cfg.start_epoch``,
    batches (with their labels when ``labels``) from the host or from
    device-resident splits, ``cfg.steps_per_dispatch`` of them per dispatch,
    logging, per-epoch checkpoints (``opt``, one optimizer or a dict of
    them, goes into the ``.opt.pt``) and best-weights tracking by the
    validation metric ``vloss_key``. ``step`` / ``evaluate`` take ``(x, y,
    generator=)``. Under ``mesh`` each process runs its rows of each batch
    (see the module docstring): a batch that does not divide the mesh
    runs alone, wrap-padded; a validation batch that does not divide it
    runs whole on every process, so that the validation mean stays exact.
    Returns (best state_dict on the CPU, history)."""
    resume = _resume_checkpoint(model_dir, prefix, cfg.start_epoch)
    if resume is not None:
        ckpt.load_checkpoint(resume, model, opt)
        print(f"resumed from {resume}")
    feed = _DeviceFeed if cfg.device_data else _HostFeed
    train_feed, valid_feed = feed(train_ds, device, labels), feed(valid_ds, device, labels)
    whole_eval = evaluate
    if mesh is not None:
        step, evaluate = (_sharded(f, mesh, model.z_dim) for f in (step, evaluate))
    multi = None
    if cfg.steps_per_dispatch > 1:
        multi = MultiStep(step, _optimizers(opt), train_feed.data,
                          "global" if mesh is None or mesh.group is None else "thread_local")
    writer = mesh is None or mesh.rank == 0
    log = _Logger(model_dir, append=resume is not None, enabled=writer)
    history = []
    best = (np.inf, None)
    n_train = max(1, -(-len(train_ds) // cfg.batch_size))
    n_valid = max(1, -(-len(valid_ds) // cfg.batch_size))
    size = 1 if mesh is None else mesh.size
    gen = None

    for epoch in range(cfg.start_epoch, cfg.end_epoch):
        rng = np.random.default_rng((cfg.seed, epoch))
        gen = epoch_generator(cfg.seed, epoch, device, gen)
        t0 = time.perf_counter()
        acc, names, i, buf = None, None, 0, []

        def flush():
            """Run the buffered batches: K of them in one dispatch, a single
            one through the step. Each step's metrics enter the sums; the
            batch log shows the dispatch's per-step means."""
            nonlocal acc, names, i
            if not buf:
                return
            if len(buf) > 1:
                rows = slice(None) if mesh is None else _mine(train_feed.size(buf[0]), mesh)
                vals = multi(*train_feed.stack(buf, rows), generator=gen)
                train_feed.sent()
                names = multi.names
            else:
                rows = None if mesh is None else _pad_shardable(train_feed.size(buf[0]), mesh)
                m = step(*train_feed.one(buf[0], rows), generator=gen)
                names = list(m)
                vals = torch.stack([m[k] for k in names])[None]
            part = vals.sum(0, dtype=torch.float64)
            acc = part if acc is None else acc + part
            if i % cfg.log_interval < len(buf):
                log.batch(f"Train Epoch: {epoch:2d} [{i}/{n_train}]    "
                          f"{_fmt(dict(zip(names, vals.mean(0))))}")
            i += len(buf)
            buf.clear()

        group = cfg.steps_per_dispatch
        first = None
        for item in train_feed.batches(cfg.batch_size, rng, cfg.drop_last):
            n = train_feed.size(item)
            first = n if first is None else first
            if n != first or n % size:  # a ragged or unshardable batch runs alone
                flush()
                buf.append(item)
                flush()
                continue
            buf.append(item)
            if len(buf) >= group:
                flush()
        flush()
        # divide by the steps run: with drop_last the trailing batch never runs
        train_avg = {} if acc is None else {
            k: v / max(i, 1) for k, v in zip(names, acc.tolist())}

        totals = {}
        for item in valid_feed.batches(cfg.batch_size):
            n = valid_feed.size(item)
            if mesh is None or n % size:
                m = whole_eval(*valid_feed.one(item), generator=gen)
            else:
                m = evaluate(*valid_feed.one(item, _pad_shardable(n, mesh)), generator=gen)
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + v.double()
        valid_avg = {k: float(v) / n_valid for k, v in totals.items()}

        dt = time.perf_counter() - t0
        log.epoch(f"Epoch: {epoch} ({dt:.1f}s)")
        log.epoch(f"[Train]\t\t {_fmt(train_avg)}")
        log.epoch(f"[Validation]\t {_fmt(valid_avg)}")

        vloss = valid_avg[vloss_key]
        name = ckpt.checkpoint_name(prefix, epoch, vloss)
        if writer:
            ckpt.save_checkpoint(model_dir, name, model, opt,
                                 metadata={"epoch": epoch, **valid_avg})
        history.append({"epoch": epoch, "train": train_avg, "valid": valid_avg})
        if vloss < best[0]:
            best = (vloss, _state_cpu(model))

    return (_state_cpu(model) if best[1] is None else best[1]), history


def _prepare(model, cfg: LoopConfig, mesh, init_state_dict, device):
    """Start ``model``'s weights on the device: Xavier-normal from a
    generator seeded by ``cfg.seed``, or ``init_state_dict``; under
    ``mesh`` on this process's device, then broadcast from rank 0. Returns
    (device, whether the steps run K per dispatch)."""
    if cfg.steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {cfg.steps_per_dispatch}")
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh.device
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(f"device={device!r} but the mesh is on {dev}")
    model.to("cpu")
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict, strict=True)
    else:
        init_xavier_(model, torch.Generator().manual_seed(cfg.seed))
    model.to(dev)
    if mesh is not None:
        replicate(model, mesh)
    return dev, cfg.steps_per_dispatch > 1


def _capturable(dev, multi: bool) -> bool:
    """Adam keeps its step counts on the card when a CUDA graph runs it."""
    return multi and dev.type == "cuda"


def _need_labels(ds, who: str) -> None:
    if ds.arrays[1] is None:
        raise ValueError(f"{who} needs a dataset with labels y")


def fit_vae(model, train_ds, valid_ds, model_dir, prefix: str, conditional: bool = False,
            cfg: LoopConfig = LoopConfig(), mesh=None, init_state_dict=None, device=None):
    """Train M1, or with ``conditional=True`` an M2 (``CVAE``, ``CVAE_v2``,
    ``CVAE_v3``) on the datasets' labels, on ``device`` (CUDA unless
    ``device="cpu"``). Returns (best state_dict, history).

    The weights start Xavier-normal from a generator seeded by ``cfg.seed``,
    or from ``init_state_dict``; ``start_epoch > 1`` then resumes weights and
    Adam state from the previous epoch's checkpoint in ``model_dir``.
    ``cfg.std_norm`` normalizes the encoder input by ``train_ds.mean_std``.
    Checkpoints are named by the validation ELBO.
    """
    if conditional:
        _need_labels(train_ds, "fit_vae(conditional=True)")
    dev, multi = _prepare(model, cfg, mesh, init_state_dict, device)
    norm = train_ds.mean_std if cfg.std_norm else None
    opt = adam(model.parameters(), cfg.learning_rate, _capturable(dev, multi))
    step = make_train_step(model, opt, conditional, cfg.eps, norm, keep_grads=multi,
                           grad_hook=grad_allreduce(mesh))
    evaluate = make_eval_step(model, conditional, cfg.eps, norm)
    return _run_epochs(model, opt, step, evaluate, train_ds, valid_ds, model_dir, prefix,
                       cfg, dev, conditional, "elbo", mesh)


def fit_semisup(model, train_ds, valid_ds, model_dir, prefix: str, objective: str,
                alpha: float, y_cond: str = "soft", cfg: LoopConfig = LoopConfig(),
                mesh=None, init_state_dict=None, device=None):
    """Train a ``CVAE_v3`` on the semi-supervised objective (see
    ``steps.make_semisup_step``), the trainer behind the reference's
    ``ntcd_M2v3_VAD_{U,L}loss_alpha_*`` checkpoints. Checkpoints are named
    by the validation loss (objective - alpha * BCE). Returns (best
    state_dict, history)."""
    if cfg.std_norm:
        # the semisup step has no norm path (every such reference checkpoint
        # is 'nonorm'): refuse rather than train on unnormalized inputs
        raise ValueError("fit_semisup does not support std_norm")
    _need_labels(train_ds, "fit_semisup")
    dev, multi = _prepare(model, cfg, mesh, init_state_dict, device)
    opt = adam(model.parameters(), cfg.learning_rate, _capturable(dev, multi))
    step = make_semisup_step(model, opt, objective, alpha, y_cond, cfg.eps, keep_grads=multi,
                             grad_hook=grad_allreduce(mesh))
    evaluate = make_semisup_eval_step(model, objective, alpha, y_cond, cfg.eps)
    return _run_epochs(model, opt, step, evaluate, train_ds, valid_ds, model_dir, prefix,
                       cfg, dev, True, "loss", mesh)


def fit_adversarial(model, train_ds, valid_ds, model_dir, prefix: str, alpha: float,
                    beta: float, gamma: float, cfg: LoopConfig = LoopConfig(), mesh=None,
                    init_state_dict=None, legacy_aux_coupling: bool = False,
                    use_y_hat_soft: bool = False, freeze_classifier: bool = False,
                    y_cond: str | None = None, enc_adversary: str = "bce", device=None):
    """Train M2-info (``DisentangledVAE``) or a ``CVAE_v4`` by the
    two-optimizer adversarial game (see ``steps.make_adversarial_step``):
    two Adams, the encoder group's and the auxiliary's, both in each
    epoch's ``.opt.pt`` and both restored on resume. ``init_state_dict``
    starts from given weights (a pretrained classifier, say).
    ``freeze_classifier`` keeps the x -> y classifier fixed. ``cfg.std_norm``
    normalizes every model input. Checkpoints are named by the validation
    encoder loss (training_M2_info_vad.py:280-281). Returns (best
    state_dict, history)."""
    _need_labels(train_ds, "fit_adversarial")
    dev, multi = _prepare(model, cfg, mesh, init_state_dict, device)
    opt_enc, opt_aux = init_adversarial_state(model, cfg.learning_rate, _capturable(dev, multi))
    norm = train_ds.mean_std if cfg.std_norm else None
    kw = dict(use_y_hat_soft=use_y_hat_soft, y_cond=y_cond, norm=norm,
              enc_adversary=enc_adversary)
    step = make_adversarial_step(
        model, opt_enc, opt_aux, alpha, beta, gamma, cfg.eps,
        legacy_aux_coupling=legacy_aux_coupling,
        freeze_substring="classifier" if freeze_classifier else None, keep_grads=multi,
        grad_hook=grad_allreduce(mesh), **kw)
    evaluate = make_adversarial_eval_step(model, alpha, beta, gamma, cfg.eps, **kw)
    return _run_epochs(model, {"enc": opt_enc, "aux": opt_aux}, step, evaluate, train_ds,
                       valid_ds, model_dir, prefix, cfg, dev, True, "enc", mesh)
