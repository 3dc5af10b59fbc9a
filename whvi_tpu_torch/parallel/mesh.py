"""Meshes of ranks and the sharded MC-ELBO (PyTorch, ``torch.distributed``).

Counterpart of :mod:`whvi_tpu.parallel.mesh`. The JAX module shards the
MC samples over a ``sample`` mesh axis and the batch rows over ``data``
inside one SPMD program, and XLA reduces the gradients through AD of a
``psum``. Here every rank of the world is a process that runs the port's
single-device code (K1-K4) on its block of samples and rows, and the
collectives are explicit ``torch.distributed`` calls:

- Parameters and the batch are replicated: every rank holds the whole
  batch and the generator at the same state.
- Noise: every rank draws the **global** noise of every layer, at the
  global ``(S, B)`` (``WHVINetwork.draw_noise``: the draws a one-device
  forward makes, in its order), and slices its own sample range, and its
  own row range where the noise is per example. So the sharded estimator
  equals the one-device port's for the same generator seed, with per-batch
  and with per-example noise alike, and no data shard repeats another's
  noise. The JAX module folds the data-shard index into the keys instead
  (mesh.py:109-118), because a JAX shard draws at its local shape; its
  per-example-noise estimator therefore differs from its one-device one,
  and the port's noise stream differs from JAX's anyway (parity is for
  given noise).
- A rank's loss is ``mnll_share + kl_scale * kl / world``, the share
  scaled by the global ``S``, ``B`` and weight sum, so that the shares sum
  to the global MNLL; every rank has the whole batch, so the weighted
  estimator's denominator (JAX's separate psum, mesh.py:151) needs no
  collective. One backward, then **one** SUM all-reduce of the flattened
  gradients, which also carries the MNLL share: one collective a step.
  (``torch.distributed.nn.functional.all_reduce`` on the loss would
  all-reduce the gradient again in its backward, multiplying it by the
  world size.)
- Predictions: each rank computes its ``(S / sample, B / data)`` block;
  :meth:`Mesh.gather` assembles the whole by a SUM all-reduce into a
  zero-filled buffer, the one collective gloo takes on CUDA tensors
  besides broadcast.

Every collective goes through a :class:`Mesh` and is counted in
:data:`COLLECTIVES`.
"""

from __future__ import annotations

import collections
import math

import torch
import torch.distributed as dist

from whvi_tpu_torch.models.likelihoods import _scalar
from whvi_tpu_torch.parallel.distributed import init_distributed
from whvi_tpu_torch.train.trainer import TrainConfig, Trainer

__all__ = [
    "COLLECTIVES",
    "Mesh",
    "local_noise",
    "make_mesh",
    "make_sharded_predict",
    "make_sharded_train_step",
    "make_split_mesh",
    "reset_collectives",
    "sharded_loss_fn",
]

COLLECTIVES: collections.Counter = collections.Counter()  # per process, by kind


def reset_collectives() -> None:
    COLLECTIVES.clear()


class Mesh:
    """The world's ranks laid out over named axes, the last axis fastest
    (rank ``r`` of a ``(data, sample)`` mesh sits at ``(r // sample, r %
    sample)``, as JAX's ``reshape(data, sample)`` of the device list). Its
    size must be the world's. ``shape``: axis name -> size; ``index``:
    this rank's coordinate on each axis."""

    def __init__(self, shape: dict):
        init_distributed()
        world = dist.get_world_size()
        size = math.prod(shape.values())
        axes = ", ".join(f"{k}={v}" for k, v in shape.items())
        if size > world:
            raise ValueError(f"need {size} devices for mesh ({axes}), have {world}")
        if size < world:
            raise ValueError(f"mesh ({axes}) has {size} ranks; the world has {world}")
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = size
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        index, r = {}, self.rank
        for name in reversed(self.axis_names):
            index[name] = r % shape[name]
            r //= shape[name]
        self.index = {name: index[name] for name in self.axis_names}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, {self.backend})"

    def shards(self, axes) -> int:
        """The number of blocks over ``axes`` (a name or a tuple of names)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def part(self, n: int, axes) -> slice:
        """This rank's block of ``n`` split evenly over ``axes`` (a name or
        a tuple of names, the first major)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        k, i = self.shards(axes), 0
        for a in axes:
            i = i * self.shape[a] + self.index[a]
        if n % k:
            raise ValueError(f"{n} does not split over {k} shards ({'x'.join(axes)})")
        m = n // k
        return slice(i * m, (i + 1) * m)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over every rank, in place."""
        COLLECTIVES["all_reduce"] += 1
        dist.all_reduce(t, op)
        return t

    def gather(self, block: torch.Tensor, dims: dict) -> torch.Tensor:
        """The whole of a tensor of which every rank holds ``block``, split
        along dim ``d`` over ``dims[d]`` (axes as :meth:`part` takes them):
        a SUM all-reduce into a zero-filled buffer (exact: each element has
        one nonzero term; bf16 and bool travel as float32 and uint8)."""
        shape = list(block.shape)
        index = [slice(None)] * block.dim()
        for d, axes in dims.items():
            shape[d] *= self.shards(axes)
            index[d] = self.part(shape[d], axes)
        wide = block.dtype
        if block.dtype == torch.bool:
            wide = torch.uint8
        elif block.is_floating_point() and block.element_size() < 4:
            wide = torch.float32
        buf = torch.zeros(shape, dtype=wide, device=block.device)
        buf[tuple(index)] = block
        return self.all_reduce(buf).to(block.dtype)

    def max(self, values) -> list[float]:
        """The largest of each of ``values`` (floats) over every rank: the
        same numbers on every rank."""
        dev = torch.device("cuda", torch.cuda.current_device()) if self.backend == "nccl" else "cpu"
        t = torch.tensor(values, dtype=torch.float64, device=dev)
        return self.all_reduce(t, dist.ReduceOp.MAX).tolist()

    def agree(self, flag: bool) -> bool:
        """``flag`` on any rank: one decision for every rank (e.g. to run
        one more warm-up round), so that they stay in step."""
        return bool(self.max([float(flag)])[0])

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def make_mesh(data: int = 1, sample: int = 1) -> Mesh:
    """A ``(data, sample)`` mesh over the world's ranks (a world of one if
    no group was joined, see :func:`init_distributed`); ``data * sample``
    must be the world size."""
    return Mesh({"data": data, "sample": sample})


def make_split_mesh() -> Mesh:
    """The 1-D ``("split",)`` mesh over every rank, which shards a replica
    stack (the JAX package's ``Mesh(devices, ("split",))``)."""
    init_distributed()
    return Mesh({"split": dist.get_world_size()})


def local_noise(eps: list, samples: slice, rows: slice | None, B: int) -> list:
    """A rank's block of per-layer global noise ``eps`` (``(S, 1, ...)``
    shared, ``(S, B, ...)`` per example): its ``samples`` (or, on a split
    mesh, its replicas) on the leading axis, and its ``rows`` of
    per-example noise (``rows`` None: all). With more than one data shard
    ``B >= 2``, so the two layouts cannot be confused."""

    def cut(e):
        if e is None:
            return None
        if isinstance(e, tuple):
            return tuple(cut(v) for v in e)
        e = e[samples]
        return e[:, rows] if rows is not None and e.shape[1] == B else e

    return [cut(e) for e in eps]


def _check_samples(mesh: Mesh, n_samples: int) -> int:
    s = mesh.shape["sample"]
    if n_samples % s:
        raise ValueError(f"n_samples={n_samples} not divisible by sample shards {s}")
    return n_samples // s


def _block(net, mesh: Mesh, n_samples: int, x, generator, eps):
    """This rank's rows of ``x`` (a fresh 16-byte-aligned copy when they
    start past row 0: the kernels' wrappers copy misaligned operands) and
    its block of the global noise."""
    B = x.shape[0]
    if eps is None:
        eps = net.draw_noise((n_samples, B), generator, x.dtype, x.device)
    rows = mesh.part(B, "data") if mesh.shape["data"] > 1 else None
    x_local = x if rows is None else x[rows].clone()
    return rows, x_local, local_noise(eps, mesh.part(n_samples, "sample"), rows, B)


def sharded_loss_fn(net, mesh: Mesh, n_samples: int, ignore_kl: bool = False):
    """``loss(x, y, n, generator, kl_scale=1.0, weights=None, eps=None) ->
    (loss, {"mnll", "kl"})``: the MC-ELBO of ``n_samples`` samples with the
    samples split over ``sample`` and the rows of ``x (B, n_in)`` over
    ``data``, equal to ``net.loss`` on one device for the same generator
    state (or the same global ``eps``, per-layer as ``net.loss`` takes it).
    It runs the backward and leaves the global gradient in every
    parameter's ``.grad`` (one all-reduce); the returned values are
    detached and the same on every rank."""
    S_local = _check_samples(mesh, n_samples)

    def loss(x, y, n, generator=None, kl_scale=1.0, weights=None, eps=None):
        B = x.shape[0]
        rows, x_local, eps_local = _block(net, mesh, n_samples, x, generator, eps)
        y_hat = net.predict(x_local, S_local, eps=eps_local)
        y_local = y if rows is None else y[rows]
        lp = net.likelihood.log_prob(y_local, y_hat)  # (S_local, B_local)
        if weights is None:
            total = torch.sum(lp)
            share = _scalar(-(n / (n_samples * B)), total) * total
        else:
            w = weights if rows is None else weights[rows]
            share = -(n / (n_samples * torch.sum(weights))) * torch.sum(lp * w)
        kl = net.kl()
        local = share if ignore_kl else share + kl_scale * kl / mesh.size
        params = list(net.parameters())
        grads = torch.autograd.grad(local, params, allow_unused=True)
        flat = torch.cat(
            [torch.zeros(p.numel(), device=p.device) if g is None else g.float().reshape(-1)
             for p, g in zip(params, grads)]
            + [share.detach().float().reshape(1)]
        )
        mesh.all_reduce(flat)
        off = 0
        for p in params:
            g = flat[off : off + p.numel()].view_as(p).to(p.dtype)
            off += p.numel()
            if p.grad is None:
                p.grad = g
            else:
                p.grad.copy_(g)
        mnll = flat[-1]
        kl = kl.detach()
        return (mnll if ignore_kl else mnll + kl_scale * kl), {"mnll": mnll, "kl": kl}

    return loss


def make_sharded_predict(net, mesh: Mesh, n_samples: int):
    """``predict(x, generator=None, eps=None)``: this rank's ``(S / sample,
    B / data, n_out)`` block of the posterior predictive of ``x (B, n_in)``
    (the JAX output, sharded ``P("sample", "data")``); ``predict.gather(
    block)`` assembles ``(S, B, n_out)``, equal to ``net.predict(x, S,
    generator)`` on one device for the same generator state. ``B`` must
    split over ``data`` (the trainer pads rows to that multiple)."""
    S_local = _check_samples(mesh, n_samples)

    @torch.no_grad()
    def predict(x, generator=None, eps=None):
        _, x_local, eps_local = _block(net, mesh, n_samples, x, generator, eps)
        return net.predict(x_local, S_local, eps=eps_local)

    predict.gather = lambda block: mesh.gather(block, {0: "sample", 1: "data"})
    return predict


def make_sharded_train_step(net, mesh: Mesh, config: TrainConfig = TrainConfig(), device=None):
    """The train step of a :class:`~whvi_tpu_torch.train.Trainer` on
    ``mesh`` (its loss :func:`sharded_loss_fn`): ``step(state, x, y, n,
    train_likelihood, weights=None) -> metrics`` (device tensors, the same
    on every rank), with the phase flag and ``config``'s KL warm-up and
    noise freeze applied after the reduction (a freeze checks the split
    head up front). ``step.init(seed)`` makes the state,
    ``step.scan(state, x, y, n, train_likelihood, k, weights=None)`` runs
    ``k`` steps and reads the last metrics to the host once, as floats;
    ``step.trainer`` is the trainer. Every rank applies the same reduced
    gradient, so the parameters stay equal across ranks."""
    trainer = Trainer(net, config, device=device, mesh=mesh)

    def step(state, x, y, n, train_likelihood, weights=None):
        return trainer.train_step(state, x, y, n, train_likelihood, weights=weights)

    def scan(state, x, y, n, train_likelihood, k: int, weights=None) -> dict:
        for _ in range(k):
            metrics = step(state, x, y, n, train_likelihood, weights)
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    step.scan = scan
    step.init = trainer.init
    step.trainer = trainer
    return step
