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
Checkpoints, the mesh, vmapped splits and traced hyperparameters are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from whvi_tpu_torch.train.optim import (
    decayed_adam,
    mask_likelihood_grads,
    mask_noise_branch_grads,
    validate_split_head,
)

__all__ = ["TrainConfig", "TrainState", "Trainer", "batch_layout"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of the two-phase ELBO protocol (defaults: the
    reference UCI protocol). ``kl_warmup_steps`` scales the KL term by
    ``min(1, step / kl_warmup_steps)`` with the step count before the
    update (0 disables). ``noise_freeze_steps`` freezes the noise branch
    of a heteroscedastic split head while the step count before the
    update is below it (0 disables; any other value needs the split
    head)."""

    lr0: float = 1e-3
    gamma: float = 5e-4
    p: float = 0.3
    batch_size: int = 64
    epochs1: int = 500
    epochs2: int = 50000
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


def batch_layout(n_train: int, batch_size: int, dtype=torch.float32, device=None):
    """``(B, num_batches, weights)`` of an epoch: ``B = min(batch_size,
    n_train)``, the index range wrap-padded to ``num_batches * B`` rows,
    ``weights (num_batches, B)`` 1 for real rows and 0 for padding."""
    B = min(batch_size, n_train)
    num_batches = -(-n_train // B)
    weights = (torch.arange(num_batches * B, device=device) < n_train).to(dtype)
    return B, num_batches, weights.reshape(num_batches, B)


class Trainer:
    """Binds a network, a config and a device.

    Usage::

        trainer = Trainer(net, config, device="cuda")
        state = trainer.init(seed=0)
        state, logs = trainer.fit(state, X, y)
        metrics = trainer.evaluate(X_test, y_test, generator)
    """

    def __init__(self, net, config: TrainConfig = TrainConfig(), device=None):
        self.device = torch.device(
            device if device is not None else next(net.parameters()).device
        )
        self.net = net.to(self.device)
        self.config = config
        self.dtype = next(net.parameters()).dtype
        if config.noise_freeze_steps > 0:
            validate_split_head(net)

    def init(self, seed: int) -> TrainState:
        """Fresh parameters and optimizer from one ``torch.Generator`` on
        the trainer's device; the run's noise and permutations continue
        its stream."""
        cfg = self.config
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        self.net.reset_parameters(generator)
        optimizer, scheduler = decayed_adam(
            self.net.parameters(), cfg.lr0, cfg.gamma, cfg.p
        )
        # every parameter holds a gradient tensor from the start, so Adam
        # never skips one (see optim.py)
        for param in self.net.parameters():
            param.grad = torch.zeros_like(param)
        return TrainState(optimizer, scheduler, generator)

    def train_step(
        self, state: TrainState, x, y, n, train_likelihood: bool,
        weights=None, eps=None,
    ) -> dict:
        """One ELBO step; returns the step's loss, mnll and kl as device
        tensors (no host sync). ``eps``: optional per-layer noise."""
        cfg = self.config
        if cfg.kl_warmup_steps > 0:
            kl_scale = min(1.0, state.step / cfg.kl_warmup_steps)
        else:
            kl_scale = 1.0
        state.optimizer.zero_grad(set_to_none=False)
        loss, aux = self.net.loss(
            x,
            y,
            n,
            state.generator,
            ignore_kl=cfg.ignore_kl,
            kl_scale=kl_scale,
            weights=weights,
            eps=eps,
        )
        loss.backward()
        mask_likelihood_grads(self.net, train_likelihood)
        if cfg.noise_freeze_steps > 0:
            mask_noise_branch_grads(self.net, state.step >= cfg.noise_freeze_steps)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {
            "loss": loss.detach(),
            "mnll": aux["mnll"].detach(),
            "kl": aux["kl"].detach(),
        }

    def run_epochs(self, state, X, Y, train_likelihood: bool, n_epochs: int):
        """``n_epochs`` epochs over ``X (n, d)``, ``Y (n, out)``; returns
        the last batch's metrics."""
        cfg = self.config
        n_train = X.shape[0]
        B, num_batches, weights = batch_layout(
            n_train, cfg.batch_size, X.dtype, X.device
        )
        wrap = torch.arange(num_batches * B, device=X.device) % n_train
        metrics = {}
        for _ in range(n_epochs):
            if cfg.shuffle:
                perm = torch.randperm(
                    n_train, generator=state.generator, device=X.device
                )
                idx = perm[wrap]
            else:
                idx = wrap
            xb = X[idx].reshape(num_batches, B, -1)
            yb = Y[idx].reshape(num_batches, B, -1)
            for b in range(num_batches):
                metrics = self.train_step(
                    state, xb[b], yb[b], n_train, train_likelihood,
                    weights=weights[b],
                )
        return metrics

    def _as_data(self, X, y):
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        return X, (y if y.ndim >= 2 else y[:, None])

    def fit(
        self,
        state: TrainState,
        X,
        y,
        log_fn: Callable[[dict], None] | None = None,
    ) -> tuple[TrainState, list[dict]]:
        """Run the two-phase protocol; one log entry per chunk of
        ``epochs_per_call`` epochs, with ``seconds`` since the start."""
        cfg = self.config
        X, y = self._as_data(X, y)
        logs: list[dict] = []
        total = cfg.epochs1 + cfg.epochs2
        epoch = 0
        t0 = time.perf_counter()
        while epoch < total:
            in_phase1 = epoch < cfg.epochs1
            phase_end = cfg.epochs1 if in_phase1 else total
            chunk = min(cfg.epochs_per_call, phase_end - epoch)
            metrics = self.run_epochs(state, X, y, not in_phase1, chunk)
            epoch += chunk
            # the chunk's one host fetch
            loss, mnll, kl = torch.stack(
                [metrics["loss"], metrics["mnll"], metrics["kl"]]
            ).tolist()
            seconds = time.perf_counter() - t0
            entry = {
                "epoch": epoch,
                "phase": 1 if in_phase1 else 2,
                "loss": loss,
                "mnll": mnll,
                "kl": kl,
                "seconds": seconds,
                "epochs_per_s": epoch / max(seconds, 1e-9),
            }
            logs.append(entry)
            if log_fn:
                log_fn(entry)
        return state, logs

    @torch.no_grad()
    def evaluate(self, X, y, generator: torch.Generator) -> dict:
        """Test metrics from ``eval_samples`` MC predictions: mnll,
        mnll_per_point, pred_mnll_per_point, rmse, coverage95."""
        X, y = self._as_data(X, y)
        out = self.net.eval_metrics(X, y, generator)
        values = torch.stack([v.reshape(()) for v in out.values()]).tolist()
        return dict(zip(out, values))
