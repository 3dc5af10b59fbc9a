"""The port's checkpoints against the JAX package's, on the CPU.

- The file layout and the flatten order are the JAX package's: a tree the
  port saves reads back through JAX's ``restore_checkpoint`` and the
  other way round, ``latest_checkpoint`` picks the same file, and restore
  refuses a wrong leaf count or shape where JAX's does.
- A trainer's checkpoint holds everything the next step reads: a fit of
  0 + 6 epochs with ``checkpoint_every=2``, interrupted after epoch 4 and
  resumed, equals an uninterrupted fit bit for bit (``torch.equal`` on
  parameters and Adam's moments), unreplicated and replica-stacked.
- ``convert.load_jax_checkpoint`` reads a checkpoint written by the JAX
  package's replica-stacked protocol: parameters bit-equal, predictions
  on the same noise within 1e-5.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whvi_tpu.evaluation import ProtocolConfig as JaxProtocolConfig
from whvi_tpu.evaluation import evaluate_bayesian_regression as jax_protocol
from whvi_tpu.train import latest_checkpoint as jax_latest
from whvi_tpu.train import restore_checkpoint as jax_restore
from whvi_tpu.train import save_checkpoint as jax_save

import whvi_tpu_torch.models as pm
from whvi_tpu_torch.convert import load_jax_checkpoint, param_tree
from whvi_tpu_torch.evaluation import ProtocolConfig, _build_net
from whvi_tpu_torch.models.networks import stack_replicas
from whvi_tpu_torch.train import TrainConfig, Trainer
from whvi_tpu_torch.train.checkpoint import (
    flatten,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    unflatten,
)

torch.set_num_threads(1)

F32_TOL = 1e-5


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _tree(rng):
    """A nested tree like a TrainState's: dicts with unsorted keys, tuples,
    empty dicts, scalars and integer leaves."""
    return {
        "zeta": rng.randn(3).astype(np.float32),
        "layers": ({"s2": rng.randn(2, 4).astype(np.float32), "g_mu": rng.randn(4).astype(np.float32)},
                   {}, {"w": rng.randn(4, 1).astype(np.float32)}),
        "alpha": (np.asarray(7, np.int32), {"b": rng.randn(5).astype(np.float32)}),
    }


def test_flatten_order_is_jax_tree_leaves():
    tree = _tree(np.random.RandomState(0))
    mine = flatten(tree)
    want = jax.tree.leaves(tree)
    assert len(mine) == len(want) == 6
    for a, b in zip(mine, want):
        assert a is b
    rebuilt = unflatten(tree, [a * 2 for a in mine])
    assert list(rebuilt) == list(tree)  # key order kept
    for a, b in zip(flatten(rebuilt), want):
        np.testing.assert_array_equal(a, b * 2)
    with pytest.raises(ValueError, match="more leaves"):
        unflatten(tree, mine + [mine[0]])


def test_checkpoint_files_read_both_ways(tmp_path):
    """A port checkpoint restores through JAX and a JAX one through the
    port, leaf for leaf, with the same metadata."""
    tree = _tree(np.random.RandomState(1))
    ours, theirs = str(tmp_path / "ckpt-3.npz"), str(tmp_path / "ckpt-4.npz")
    save_checkpoint(ours, tree, {"epoch": 3})
    jax_save(theirs, tree, {"epoch": 4})
    got, meta = jax_restore(ours, tree)
    assert meta == {"epoch": 3, "n_leaves": 6}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    got, meta = restore_checkpoint(theirs, tree)
    assert meta == {"epoch": 4, "n_leaves": 6}
    for a, b in zip(flatten(got), flatten(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not glob.glob(str(tmp_path / "*.tmp"))


def test_checkpoint_round_trip_of_tensors_keeps_dtype_and_device(tmp_path):
    template = {"p": (torch.zeros(2, 3), torch.zeros(4, dtype=torch.float64)),
                "g": torch.Generator().get_state(), "n": np.asarray(0, np.int64)}
    state = {"p": (torch.randn(2, 3), torch.randn(4, dtype=torch.float64)),
             "g": torch.Generator().manual_seed(5).get_state(), "n": np.asarray(9, np.int64)}
    path = save_checkpoint(str(tmp_path / "ckpt-1.npz"), state)
    got, _ = restore_checkpoint(path, template)
    for a, b in zip(flatten(got), flatten(state)):
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a.dtype == b.dtype and a == b


@pytest.mark.parametrize("names", [
    ["ckpt-2.npz", "ckpt-10.npz", "ckpt-9.npz"],
    ["ckpt-x.npz", "other-50.npz", "ckpt-3.npz", "ckpt-3.npz.meta.json", "ckpt-40.npz.tmp"],
    ["notes.txt"],
    [],
])
def test_latest_checkpoint_picks_as_jax(tmp_path, names):
    for name in names:
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == jax_latest(str(tmp_path))
    assert latest_checkpoint(str(tmp_path / "absent")) is None is jax_latest(str(tmp_path / "absent"))


@pytest.mark.parametrize("change", ["fewer_leaves", "more_leaves", "shape"])
def test_restore_refuses_where_jax_refuses(tmp_path, change):
    rng = np.random.RandomState(2)
    tree = _tree(rng)
    path = str(tmp_path / "ckpt-1.npz")
    save_checkpoint(path, tree)
    other = _tree(rng)
    if change == "fewer_leaves":
        other.pop("zeta")
    elif change == "more_leaves":
        other["extra"] = np.zeros(2, np.float32)
    else:
        other["layers"][0]["s2"] = np.zeros((2, 5), np.float32)
    match = "leaves" if change != "shape" else "shape"
    with pytest.raises(ValueError, match=match):
        jax_restore(path, other)
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(path, other)


# ------------------------------------------------------- trainer resume


def _fit(tmp_path, replicas, stop_at=None, hetero=False):
    """A 5 -> 8 -> 1 net (a split head with ``hetero``) fitted for 0 + 6
    epochs with ``checkpoint_every=2`` into ``tmp_path``; ``stop_at``
    interrupts the fit (an exception in its log) once that epoch is
    logged, after the checkpoint before it."""
    rng = np.random.RandomState(3)
    lead = () if replicas is None else (replicas,)
    X = rng.randn(*lead, 40, 5).astype(np.float32)
    y = rng.randn(*lead, 40).astype(np.float32)
    cfg = ProtocolConfig(hidden=(8,), heteroscedastic=hetero)
    net = _build_net(cfg, 5, 1)
    tcfg = TrainConfig(batch_size=16, epochs1=0, epochs2=6, checkpoint_every=2,
                       epochs_per_call=5, kl_warmup_steps=7,
                       noise_freeze_steps=9 if hetero else 0)
    trainer = Trainer(net, tcfg, device="cpu", replicas=replicas)
    state = trainer.init(11 if replicas is None else range(11, 11 + replicas))

    def log_fn(entry):
        if entry["epoch"] == stop_at:
            raise KeyboardInterrupt

    try:
        trainer.fit(state, X, y, ckpt_dir=str(tmp_path), log_fn=log_fn)
    except KeyboardInterrupt:
        return None
    return trainer, state


@pytest.mark.parametrize("replicas,hetero", [(None, False), (3, False), (2, True)])
def test_resumed_fit_equals_uninterrupted_fit(tmp_path, replicas, hetero):
    ref_trainer, ref_state = _fit(tmp_path / "ref", replicas, hetero=hetero)
    assert _fit(tmp_path / "cut", replicas, stop_at=6, hetero=hetero) is None
    saved = sorted(os.listdir(tmp_path / "cut"))
    assert saved == ["ckpt-2.npz", "ckpt-2.npz.meta.json", "ckpt-4.npz", "ckpt-4.npz.meta.json"]
    trainer, state = _fit(tmp_path / "cut", replicas, hetero=hetero)  # resumes at epoch 4
    assert state.step == ref_state.step == 6 * 3
    assert state.scheduler.last_epoch == ref_state.scheduler.last_epoch
    assert state.optimizer.param_groups[0]["lr"] == ref_state.optimizer.param_groups[0]["lr"]
    for p, q in zip(trainer.net.parameters(), ref_trainer.net.parameters()):
        assert torch.equal(p, q)
        assert p.grad is not None
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.optimizer.state[p][key], ref_state.optimizer.state[q][key])
    assert torch.equal(state.generator.get_state(), ref_state.generator.get_state())


def test_resume_keeps_gradients_and_refuses_another_net(tmp_path):
    trainer, state = _fit(tmp_path, None)
    fresh = Trainer(_build_net(ProtocolConfig(hidden=(8,)), 5, 1), trainer.config, device="cpu")
    s2 = fresh.init(0)
    fresh.restore(os.path.join(str(tmp_path), "ckpt-6.npz"), s2)
    assert all(p.grad is not None for p in fresh.net.parameters())
    other = Trainer(_build_net(ProtocolConfig(hidden=(16,)), 5, 1), trainer.config, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        other.restore(os.path.join(str(tmp_path), "ckpt-6.npz"), other.init(0))
    stacked = Trainer(_build_net(ProtocolConfig(hidden=(8,)), 5, 1), trainer.config, device="cpu",
                      replicas=2)
    with pytest.raises(ValueError, match="shape"):
        stacked.restore(os.path.join(str(tmp_path), "ckpt-6.npz"), stacked.init([0, 1]))


# ------------------------------------------------ a JAX stacked checkpoint


def _jax_layer_given_g(layer, p, h, e):
    """One JAX layer of one replica and one MC sample on its noise ``e``."""
    if e is None:
        return layer.apply(p, h, None)
    return layer.apply_given_g(p, h, p["g_mu"] + jax.nn.softplus(p["g_rho"]) * e)


def test_load_jax_checkpoint_of_a_stacked_protocol(tmp_path):
    X = np.random.RandomState(4).randn(60, 5).astype(np.float32)
    y = np.sin(X[:, :1]).astype(np.float32)
    kw = dict(n_splits=2, hidden=(8,), epochs1=1, epochs2=2, checkpoint_every=1, eval_samples=4)
    jax_protocol(X, y, JaxProtocolConfig(**kw, vmap_splits=True), ckpt_dir=str(tmp_path))
    (path,) = glob.glob(str(tmp_path / "cfg-*" / "stacked" / "ckpt-3.npz"))
    jcfg = JaxProtocolConfig(**kw)
    from whvi_tpu.evaluation import _build_net as jax_build_net

    jnet = jax_build_net(jcfg, 5, 1)
    net = stack_replicas(_build_net(ProtocolConfig(**kw), 5, 1), 2)
    meta = load_jax_checkpoint(net, path)
    assert meta["epoch"] == 3 and meta["step"] == [3, 3]  # 54 train rows: 1 batch an epoch
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    mine = flatten(param_tree(net))
    assert len(leaves) == 3 * len(mine) + 4
    for a, b in zip(mine, leaves):
        assert np.array_equal(a.detach().numpy(), b)
    # predictions on the same noise: the port's stacked forward against
    # JAX's per replica and sample
    S, B = 3, 7
    x = np.random.RandomState(5).randn(2, B, 5).astype(np.float32)
    rng = np.random.RandomState(6)
    eps = [None if not isinstance(l, pm.WHVILinear) else
           rng.randn(*l.matrix.noise_shape(torch.empty(2, S, B, l.n_in), False)).astype(np.float32)
           for l in net.layers]
    with torch.no_grad():
        got = net.predict(torch.from_numpy(x), S, eps=[None if e is None else torch.from_numpy(e)
                                                      for e in eps]).numpy()
    jparams = jax.tree.map(lambda a: jnp.asarray(a), _jax_stacked_params(jnet, leaves))
    for r in range(2):
        pr = jax.tree.map(lambda a: a[r], jparams)
        for s in range(S):
            h = jnp.asarray(x[r])
            for layer, p, e in zip(jnet.layers, pr["layers"], eps):
                h = _jax_layer_given_g(layer, p, h, None if e is None else jnp.asarray(e[r, s, 0]))
            assert rel_err(got[r, s], h) <= F32_TOL


def _jax_stacked_params(jnet, leaves):
    """The parameter part of a stacked JAX checkpoint's leaves as JAX's
    params tree."""
    template = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    treedef = jax.tree.structure(template)
    return jax.tree.unflatten(treedef, leaves[: treedef.num_leaves])


def test_load_jax_checkpoint_refuses_another_net(tmp_path):
    jtree = {"params": {"layers": ({"s1": np.zeros(4, np.float32)},)}}
    path = jax_save(str(tmp_path / "ckpt-1.npz"), jtree)
    with pytest.raises(ValueError, match="leaves"):
        load_jax_checkpoint(_build_net(ProtocolConfig(hidden=(8,)), 5, 1), path)
