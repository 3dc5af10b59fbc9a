"""ELBO training engine (PyTorch).

Counterpart of :mod:`whvi_tpu.train.trainer`. The JAX trainer compiles a
chunk of epochs into one ``lax.scan`` dispatch; here epochs and batches
are Python loops around an eager ``train_step``, and the host reads the
device once per chunk of ``epochs_per_call`` epochs, as the JAX ``fit``
fetches once per dispatch.

Protocol, as the reference's: ``epochs1`` epochs with the likelihood
frozen, then ``epochs2`` with everything trained; batch 64 with the full
dataset size ``n`` in the MNLL scaling; a fresh permutation per epoch
(``shuffle``), wrap-padded to a multiple of the batch size with weight-0
padding rows so every batch has the same shape and the padded batch's
estimator equals the unpadded one's. A heteroscedastic split head's
noise branch can be frozen for the first ``noise_freeze_steps`` steps.

Checkpoints: with a ``ckpt_dir``, ``fit`` saves ``ckpt-{epoch}.npz`` every
``checkpoint_every`` epochs of phase 2 and at the end, and with
``resume`` restores the latest one first. The state saved
(:meth:`Trainer.state_tree`) is everything the next step reads, so a
resumed fit equals an uninterrupted one bit for bit.

Replicas: ``Trainer(..., replicas=R)`` trains ``R`` independent replicas
of the net at once (:func:`whvi_tpu_torch.models.networks.stack_replicas`), the
counterpart of the JAX trainer's ``vmap_splits``: data ``X (R, n, d)``,
a permutation per replica and epoch, metrics ``(R,)``. Each replica is
initialized from its own seed, exactly as an unreplicated net from that
seed; the noise of the whole stack comes from one generator (JAX draws it
from a key per replica). ``hyper`` carries per-replica hyperparameters
(KL warm-up, noise freeze, prior variances), the config-stacked grid's.

Storage: the trainer takes the net's dtype (``Trainer.dtype``, its first
parameter's), the counterpart of JAX's ``Trainer.init(key, dtype)``. A
bf16 net (the JAX ``dtype=bfloat16``) trains in bf16: data are cast to it
as ``jnp.asarray(.., dtype)`` casts them, the padding weights, noise,
products, KL and likelihood are bf16 (the loss float32, as JAX's), and
Adam is ``OptaxAdam``, its moments bf16 (``train/optim.py``).

Meshes (:mod:`whvi_tpu_torch.parallel`): with ``mesh=`` (a ``(data,
sample)`` mesh) every rank of the world runs the same trainer, the loss is
:func:`~whvi_tpu_torch.parallel.sharded_loss_fn` (MC samples over
``sample``, batch rows over ``data``, one all-reduce a step), the batch is
rounded up to the data-shard multiple with weight-0 padding rows, and
``predict`` pads the rows to that multiple, runs the sharded predict and
gathers. ``split_mesh=`` (a ``("split",)`` mesh, with ``replicas=R``)
gives every rank ``R / world`` of the replicas, initialized from its
slice of the seeds, and its slice of the data; a step needs no
collective. Every rank draws what the unsharded run draws (global noise,
permutation keys) from the same generator and slices its own, so both
equal their one-device runs. Whatever draws from the generator runs on
every rank; checkpoints are written by rank 0 (a split stack gathered
first) and restored on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from whvi_tpu_torch.models.networks import stack_replicas
from whvi_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from whvi_tpu_torch.train.optim import (
    decayed_adam,
    mask_likelihood_grads,
    mask_noise_branch_grads,
    validate_split_head,
)
from whvi_tpu_torch.utils.profiling import span

__all__ = ["TrainConfig", "TrainState", "Trainer", "batch_layout", "hyper_schedule"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of the two-phase ELBO protocol (defaults: the
    reference UCI protocol). ``kl_warmup_steps`` scales the KL term by
    ``min(1, step / kl_warmup_steps)`` with the step count before the
    update (0 disables). ``noise_freeze_steps`` freezes the noise branch
    of a heteroscedastic split head while the step count before the
    update is below it (0 disables; any other value needs the split
    head). ``checkpoint_every``: epochs of phase 2 between checkpoints
    when ``fit`` has a ``ckpt_dir`` (0: only at the end)."""

    lr0: float = 1e-3
    gamma: float = 5e-4
    p: float = 0.3
    batch_size: int = 64
    epochs1: int = 500
    epochs2: int = 50000
    checkpoint_every: int = 5000
    epochs_per_call: int = 250
    shuffle: bool = True
    ignore_kl: bool = False
    kl_warmup_steps: int = 0
    noise_freeze_steps: int = 0


@dataclasses.dataclass
class TrainState:
    """What a run carries besides the network's parameters."""

    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    step: int = 0  # global batch step (drives the lr schedule and KL warm-up)


def batch_layout(
    n_train: int, batch_size: int, dtype=torch.float32, device=None, data_shards: int = 1,
):
    """``(B, num_batches, weights)`` of an epoch: ``B = min(batch_size,
    n_train)`` rounded up to a multiple of ``data_shards`` (a mesh's data
    axis), the index range wrap-padded to ``num_batches * B`` rows,
    ``weights (num_batches, B)`` 1 for real rows and 0 for padding."""
    B = -(-min(batch_size, n_train) // data_shards) * data_shards
    num_batches = -(-n_train // B)
    weights = (torch.arange(num_batches * B, device=device) < n_train).to(dtype)
    return B, num_batches, weights.reshape(num_batches, B)


def hyper_schedule(hyper: dict, step: int) -> tuple:
    """``(kl_scale, train_noise)`` at ``step`` from per-replica ``hyper``,
    as JAX's ``train_step`` computes them (``whvi_tpu/train/trainer.py
    :279-317``), in float32: ``kl_scale = min(1, step / max(w, 1))`` where
    ``w = kl_warmup_steps > 0``, else 1; ``train_noise = step >=
    noise_freeze_steps`` as 0/1. Each is a float32 numpy array of the
    hyperparameter's shape, or None when ``hyper`` lacks it."""
    kl_scale = train_noise = None
    t = np.float32(step)
    if "kl_warmup_steps" in hyper:
        w = np.asarray(hyper["kl_warmup_steps"], np.float32)
        kl_scale = np.where(
            w > 0, np.minimum(np.float32(1), t / np.maximum(w, np.float32(1))), np.float32(1)
        ).astype(np.float32)
    if "noise_freeze_steps" in hyper:
        nf = np.asarray(hyper["noise_freeze_steps"], np.float32)
        train_noise = (t >= nf).astype(np.float32)
    return kl_scale, train_noise


class Trainer:
    """Binds a network, a config and a device.

    Usage::

        trainer = Trainer(net, config, device="cuda")
        state = trainer.init(seed=0)
        state, logs = trainer.fit(state, X, y, ckpt_dir=...)
        metrics = trainer.evaluate(X_test, y_test, generator)
    """

    def __init__(
        self, net, config: TrainConfig = TrainConfig(), device=None,
        replicas: int | None = None, mesh=None, split_mesh=None,
    ):
        if mesh is not None and replicas is not None:
            raise ValueError(
                "replicas and mesh are mutually exclusive (replicas train on one "
                "device; shard replicas across devices with split_mesh instead)"
            )
        if split_mesh is not None and replicas is None:
            raise ValueError("split_mesh requires replicas")
        self.device = torch.device(
            device if device is not None else next(net.parameters()).device
        )
        self.replicas = replicas
        self.mesh = mesh
        self.split_mesh = split_mesh
        self._part = slice(None)  # this rank's replicas
        if replicas is not None:
            local = replicas
            if split_mesh is not None:
                self._part = split_mesh.part(replicas, "split")
                local = replicas // split_mesh.size
            stack_replicas(net, local)
        self.net = net.to(self.device)
        self.config = config
        self.dtype = next(net.parameters()).dtype
        if config.noise_freeze_steps > 0:
            validate_split_head(net)
        if mesh is not None:
            from whvi_tpu_torch.parallel.mesh import make_sharded_predict, sharded_loss_fn

            self._sharded_loss = sharded_loss_fn(net, mesh, net.train_samples, config.ignore_kl)
            make_sharded_predict(net, mesh, net.eval_samples)  # refuses eval_samples up front
        self._group = mesh or split_mesh  # the ranks that run this trainer together

    def replica_part(self, a):
        """This rank's replicas of a whole-stack ``a`` (leading axis ``R``):
        ``a`` itself without a split mesh."""
        return a if self.split_mesh is None else a[self._part]

    def gather_replicas(self, t: torch.Tensor) -> torch.Tensor:
        """The whole stack of a tensor of which this rank holds its
        replicas (leading axis): ``t`` itself without a split mesh."""
        return t if self.split_mesh is None else self.split_mesh.gather(t, {0: "split"})

    def _split_noise(self, x, n_samples: int, generator) -> list:
        """This rank's block of the whole stack's noise for ``x (R_local,
        B, n_in)``: the unsharded stack's draws, sliced."""
        from whvi_tpu_torch.parallel.mesh import local_noise

        B = x.shape[-2]
        eps = self.net.draw_noise((self.replicas, n_samples, B), generator, x.dtype, x.device)
        return local_noise(eps, self._part, None, B)

    def _refuse_hyper(self, hyper) -> None:
        if hyper and self.mesh is not None:
            raise ValueError(
                "hyper overrides ride the replica axis; they are not supported "
                "with the mesh loss"
            )

    # ---------------------------------------------------------------- init
    def init(self, seed: int | Sequence[int]) -> TrainState:
        """Fresh parameters and optimizer. An unreplicated net is drawn
        from one ``torch.Generator`` seeded ``seed`` on the trainer's
        device, whose stream the run's noise and permutations continue.
        A replicated net takes one seed a replica: replica ``r`` is drawn
        from a generator seeded ``seed[r]``, exactly as an unreplicated
        net from that seed, and the run continues replica 0's stream (on
        every rank of a split mesh, each rank holding its slice of the
        seeds' replicas)."""
        cfg = self.config
        seeds = [seed] if isinstance(seed, (int, np.integer)) else [int(s) for s in seed]
        if len(seeds) != (self.replicas or 1):
            raise ValueError(f"{len(seeds)} seeds for {self.replicas or 1} replicas")
        generator = torch.Generator(device=self.device).manual_seed(int(seeds[0]))
        if self.replicas is None:
            self.net.reset_parameters(generator)
        else:
            self.net.reset_parameters(generator, replica=0)  # the run's stream goes on from here
            for r, s in enumerate(seeds[self._part]):
                g = torch.Generator(device=self.device).manual_seed(s)
                self.net.reset_parameters(g, replica=r)
        optimizer, scheduler = decayed_adam(
            self.net.parameters(), cfg.lr0, cfg.gamma, cfg.p
        )
        # every parameter holds a gradient tensor from the start, so Adam
        # never skips one (see optim.py)
        for param in self.net.parameters():
            param.grad = torch.zeros_like(param)
        return TrainState(optimizer, scheduler, generator)

    # ----------------------------------------------------------- train step
    def _per_replica(self, values: np.ndarray):
        """A per-replica value as one float when all replicas agree (no
        tensor to copy to the device), else a ``(R,)`` tensor there."""
        if np.all(values == values.flat[0]):
            return float(values.flat[0])
        return torch.as_tensor(values, dtype=self.dtype, device=self.device)

    def train_step(
        self, state: TrainState, x, y, n, train_likelihood: bool,
        weights=None, eps=None, hyper: dict | None = None,
    ) -> dict:
        """One ELBO step; returns the step's loss, mnll and kl as device
        tensors (no host sync), ``(R,)`` on a replicated net. ``eps``:
        optional per-layer noise. ``hyper``: optional per-replica
        overrides of the config (``kl_warmup_steps``,
        ``noise_freeze_steps``: ``(R,)`` arrays; ``lambdas``: one entry a
        layer, as ``WHVINetwork.kl``), as JAX's ``train_step(hyper=...)``.

        The Loop layer's span ``whvi.loop.train_step`` covers it; inside it
        ``whvi.model.loss`` and ``whvi.model.backward`` (on a card, the
        main thread's wait while autograd's device thread runs the
        backward). Adam is torch's own ``Optimizer.step#`` range."""
        with span("whvi.loop.train_step"):
            cfg = self.config
            hyper = hyper or {}
            self._refuse_hyper(hyper)
            kl_scale, train_noise = hyper_schedule(hyper, state.step)
            if kl_scale is not None:
                kl_scale = self._per_replica(kl_scale)
            elif cfg.kl_warmup_steps > 0:
                kl_scale = min(1.0, state.step / cfg.kl_warmup_steps)
            else:
                kl_scale = 1.0
            state.optimizer.zero_grad(set_to_none=False)
            if self.mesh is not None:  # the backward and the all-reduce inside
                loss, aux = self._sharded_loss(
                    x, y, n, state.generator, kl_scale=kl_scale, weights=weights, eps=eps
                )
            else:
                if eps is None and self.split_mesh is not None:
                    eps = self._split_noise(x, self.net.train_samples, state.generator)
                loss, aux = self.net.loss(
                    x,
                    y,
                    n,
                    state.generator,
                    ignore_kl=cfg.ignore_kl,
                    kl_scale=kl_scale,
                    weights=weights,
                    eps=eps,
                    lambdas=hyper.get("lambdas"),
                )
                # replicas share no parameter: the sum's gradient is each replica's own
                with span("whvi.model.backward"):
                    (loss if self.replicas is None else loss.sum()).backward()
            mask_likelihood_grads(self.net, train_likelihood)
            if train_noise is not None:
                mask_noise_branch_grads(self.net, self._per_replica(train_noise))
            elif cfg.noise_freeze_steps > 0:
                mask_noise_branch_grads(self.net, state.step >= cfg.noise_freeze_steps)
            state.optimizer.step()
            state.scheduler.step()
            state.step += 1
            return {
                "loss": loss.detach(),
                "mnll": aux["mnll"].detach(),
                "kl": aux["kl"].detach(),
            }

    # --------------------------------------------------------- epoch runner
    def _epoch_index(self, state, n_train: int, wrap):
        """The epoch's row order, wrap-padded: ``(padded,)``, or ``(R,
        padded)`` with a permutation a replica."""
        if self.replicas is None:
            if not self.config.shuffle:
                return wrap
            perm = torch.randperm(n_train, generator=state.generator, device=wrap.device)
            return perm[wrap]
        if not self.config.shuffle:
            return wrap.expand(self.net.replicas, -1)
        keys = torch.rand(
            self.replicas, n_train, generator=state.generator, device=wrap.device,
            dtype=torch.float64,
        )  # the whole stack's, on every rank of a split mesh
        return torch.argsort(keys[self._part], dim=1)[:, wrap]

    def run_epochs(self, state, X, Y, train_likelihood: bool, n_epochs: int, hyper=None):
        """``n_epochs`` epochs over ``X (n, d)``, ``Y (n, out)`` (``(R, n,
        d)``, ``(R, n, out)`` with replicas); returns the last batch's
        metrics."""
        cfg = self.config
        n_train = X.shape[-2]
        B, num_batches, weights = batch_layout(
            n_train, cfg.batch_size, X.dtype, X.device,
            self.mesh.shape["data"] if self.mesh is not None else 1,
        )
        wrap = torch.arange(num_batches * B, device=X.device) % n_train
        metrics = {}
        for _ in range(n_epochs):
            idx = self._epoch_index(state, n_train, wrap)
            if self.replicas is None:
                xb = X[idx].reshape(num_batches, B, -1)
                yb = Y[idx].reshape(num_batches, B, -1)
            else:
                # (num_batches, R, B, .): each batch one contiguous block
                R = self.net.replicas
                rows = torch.arange(R, device=X.device)[:, None]
                xb = X[rows, idx].reshape(R, num_batches, B, -1)
                yb = Y[rows, idx].reshape(R, num_batches, B, -1)
                xb = xb.transpose(0, 1).contiguous()
                yb = yb.transpose(0, 1).contiguous()
            for b in range(num_batches):
                metrics = self.train_step(
                    state, xb[b], yb[b], n_train, train_likelihood,
                    weights=weights[b], hyper=hyper,
                )
        return metrics

    def _as_data(self, X, y):
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        data_ndim = 2 if self.replicas is None else 3
        return self.replica_part(X), self.replica_part(y if y.ndim >= data_ndim else y[..., None])

    # ----------------------------------------------------------- checkpoint
    def state_tree(self, state: TrainState) -> dict:
        """Everything the next step reads, as a checkpoint tree: the
        parameters, Adam's moments and step counts (zeros before the first
        step), the LambdaLR's ``last_epoch``, the step counter and the
        generator's state."""
        params = tuple(self.net.parameters())
        opt = state.optimizer.state

        def adam(p, key):
            if p in opt:
                return opt[p][key]
            return torch.zeros_like(p) if key != "step" else torch.zeros((), dtype=torch.float32)

        return {
            "params": params,
            "exp_avg": tuple(adam(p, "exp_avg") for p in params),
            "exp_avg_sq": tuple(adam(p, "exp_avg_sq") for p in params),
            "adam_step": tuple(adam(p, "step") for p in params),
            "lr_epoch": np.asarray(state.scheduler.last_epoch, np.int64),
            "step": np.asarray(state.step, np.int64),
            "generator": state.generator.get_state(),
        }

    @torch.no_grad()
    def load_state_tree(self, state: TrainState, tree: dict) -> None:
        """Set ``state`` and the net's parameters from a tree of
        :meth:`state_tree`'s structure, in place: the parameters (their
        preset zero gradients stay), Adam's state, the LambdaLR at the
        saved epoch with the learning rate it set there, the step counter
        and the generator."""
        params = tuple(self.net.parameters())
        for p, v in zip(params, tree["params"]):
            p.copy_(v)
        sd = state.optimizer.state_dict()
        sd["state"] = {
            i: {
                "step": tree["adam_step"][i].to(torch.float32).cpu(),
                "exp_avg": tree["exp_avg"][i],
                "exp_avg_sq": tree["exp_avg_sq"][i],
            }
            for i in range(len(params))
        }
        sched = state.scheduler
        epoch = int(tree["lr_epoch"])
        for group, base, lam in zip(sd["param_groups"], sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * lam(epoch)  # what LambdaLR.step set there
        state.optimizer.load_state_dict(sd)
        sched.last_epoch = epoch
        sched._last_lr = [g["lr"] for g in state.optimizer.param_groups]
        state.step = int(tree["step"])
        state.generator.set_state(tree["generator"].cpu())

    _STACKED = ("params", "exp_avg", "exp_avg_sq")  # a leading replica axis

    def _whole_tree(self, state: TrainState) -> dict:
        """:meth:`state_tree` of the whole stack (gathered over a split
        mesh: every rank takes part)."""
        tree = self.state_tree(state)
        if self.split_mesh is not None:
            for k in self._STACKED:
                tree[k] = tuple(self.gather_replicas(t) for t in tree[k])
        return tree

    def save(self, path: str, state: TrainState, metadata: dict | None = None) -> None:
        """Save ``state`` to ``path`` (rank 0 writes; every rank of a mesh
        calls, and returns once the file is there)."""
        tree = self._whole_tree(state)
        if self._group is None or self._group.rank == 0:
            save_checkpoint(path, tree, metadata)
        if self._group is not None:
            self._group.barrier()

    def restore(self, path: str, state: TrainState) -> dict:
        """Restore ``state`` from the checkpoint ``path`` (on every rank of a
        mesh, each taking its replicas of a split stack); returns its
        metadata. Raises on a checkpoint of another net or optimizer."""
        tree, meta = restore_checkpoint(path, self._whole_tree(state))
        for k in self._STACKED:
            tree[k] = tuple(self.replica_part(t) for t in tree[k])
        self.load_state_tree(state, tree)
        return meta

    def _hyper_on_device(self, hyper: dict | None) -> dict | None:
        if not hyper:
            return None
        if "noise_freeze_steps" in hyper:
            validate_split_head(self.net)

        def put(t):
            if t is None:
                return None
            if isinstance(t, (tuple, list)):
                return tuple(put(v) for v in t)
            return self.replica_part(torch.as_tensor(t, dtype=self.dtype, device=self.device))

        out = {
            k: self.replica_part(np.asarray(v, np.float32))
            for k, v in hyper.items() if k != "lambdas"
        }
        if hyper.get("lambdas") is not None:
            out["lambdas"] = put(hyper["lambdas"])
        return out

    # ------------------------------------------------------------------ fit
    def fit(
        self,
        state: TrainState,
        X,
        y,
        ckpt_dir: str | None = None,
        log_fn: Callable[[dict], None] | None = None,
        resume: bool = True,
        hyper: dict | None = None,
    ) -> tuple[TrainState, list[dict]]:
        """Run the two-phase protocol; one log entry per chunk of at most
        ``epochs_per_call`` epochs, with ``seconds`` since the start of
        this call and ``epochs_per_s`` over this call's epochs.

        With a ``ckpt_dir`` a chunk of phase 2 also stops at the next
        checkpoint boundary, and ``ckpt-{epoch}.npz`` is saved every
        ``checkpoint_every`` epochs of phase 2 and at the end; with
        ``resume`` the latest checkpoint there is restored first and
        training continues from its epoch. With replicas, ``X (R, n, d)``
        / ``y (R, n[, out])``, the logged metrics are replica means and a
        checkpoint holds the whole stack. ``hyper``: per-replica overrides
        (see :meth:`train_step`)."""
        cfg = self.config
        self._refuse_hyper(hyper)
        hyper = self._hyper_on_device(hyper)
        X, y = self._as_data(X, y)
        start_epoch = 0
        if ckpt_dir and resume:
            path = latest_checkpoint(ckpt_dir)
            if path is not None:
                start_epoch = int(self.restore(path, state).get("epoch", 0))
        logs: list[dict] = []
        total = cfg.epochs1 + cfg.epochs2
        epoch = start_epoch
        t0 = time.perf_counter()
        while epoch < total:
            in_phase1 = epoch < cfg.epochs1
            phase_end = cfg.epochs1 if in_phase1 else total
            chunk = min(cfg.epochs_per_call, phase_end - epoch)
            if ckpt_dir and not in_phase1 and cfg.checkpoint_every > 0:
                # stop the chunk at the next checkpoint boundary
                next_ckpt = cfg.epochs1 + (
                    (epoch - cfg.epochs1) // cfg.checkpoint_every + 1
                ) * cfg.checkpoint_every
                chunk = min(chunk, next_ckpt - epoch)
            metrics = self.run_epochs(state, X, y, not in_phase1, chunk, hyper)
            epoch += chunk
            # the chunk's one host fetch (replica means)
            values = torch.stack(
                [metrics[k].float().reshape(-1) for k in ("loss", "mnll", "kl")]
            )
            if self.split_mesh is not None:
                values = self.split_mesh.gather(values, {1: "split"})
            loss, mnll, kl = values.mean(dim=1).tolist()
            seconds = time.perf_counter() - t0
            entry = {
                "epoch": epoch,
                "phase": 1 if in_phase1 else 2,
                "loss": loss,
                "mnll": mnll,
                "kl": kl,
                "seconds": seconds,
                "epochs_per_s": (epoch - start_epoch) / max(seconds, 1e-9),
            }
            logs.append(entry)
            if log_fn:
                log_fn(entry)
            if ckpt_dir and not in_phase1 and (
                (cfg.checkpoint_every > 0 and (epoch - cfg.epochs1) % cfg.checkpoint_every == 0)
                or epoch == total
            ):
                os.makedirs(ckpt_dir, exist_ok=True)
                self.save(os.path.join(ckpt_dir, f"ckpt-{epoch}.npz"), state, {"epoch": epoch})
        return state, logs

    # ------------------------------------------------------------ evaluate
    @torch.no_grad()
    def predict(self, X, generator: torch.Generator, n_samples: int | None = None):
        """``eval_samples`` (or ``n_samples``) MC predictions of ``X``:
        ``(S, B, out)``, ``(R, S, B, out)`` with replicas. On a mesh, the
        rows are zero-padded to the data-shard multiple, predicted sharded,
        gathered and cut back; on a split mesh ``X`` is the whole stack's
        and the result this rank's replicas (:meth:`gather_replicas`)."""
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        S = self.net.eval_samples if n_samples is None else n_samples
        if self.mesh is not None:
            from whvi_tpu_torch.parallel.mesh import make_sharded_predict

            B = X.shape[0]
            pad = -B % self.mesh.shape["data"]
            pred = make_sharded_predict(self.net, self.mesh, S)
            return pred.gather(pred(torch.nn.functional.pad(X, (0, 0, 0, pad)), generator))[:, :B]
        if self.split_mesh is not None:
            X = self.replica_part(X)
            return self.net.predict(X, S, eps=self._split_noise(X, S, generator))
        return self.net.predict(X, S, generator)

    @torch.no_grad()
    def metrics(self, y, y_hat) -> dict:
        """Test metrics of predictions ``y_hat`` (:meth:`predict`): floats,
        or ``(R,)`` numpy arrays with replicas (every replica's, on a split
        mesh, from ``y`` of the whole stack)."""
        y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        y = self.replica_part(y if y.ndim >= y_hat.ndim - 1 else y[..., None])
        out = self.net.metrics_from_predictions(y, y_hat)
        values = torch.stack([v.reshape(-1) for v in out.values()])
        values = (values if self.split_mesh is None else self.split_mesh.gather(values, {1: "split"}))
        values = values.cpu().numpy()
        if self.replicas is None:
            return {k: float(v[0]) for k, v in zip(out, values)}
        return {k: v.astype(np.float64) for k, v in zip(out, values)}

    @torch.no_grad()
    def evaluate(self, X, y, generator: torch.Generator) -> dict:
        """Test metrics from ``eval_samples`` MC predictions: mnll,
        mnll_per_point, pred_mnll_per_point, rmse, coverage95 (floats, or
        ``(R,)`` arrays with replicas)."""
        return self.metrics(y, self.predict(X, generator))
