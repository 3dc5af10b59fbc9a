"""bf16 storage (the JAX package's ``dtype=bfloat16``) in the port, against
the JAX package on the CPU.

On bf16 leaves the JAX package computes the XLA expression
``s1 * fwht(u * fwht(s2 * x))`` (backend ``"xla"``, FWHT at ``"highest"``),
each op rounding to bf16 and each transform summing in fp32; its Pallas
kernels cannot store bf16. The port's plain versions round at the same
points, so the two differ only where an fp32 sum runs in another order
(butterflies here, matmuls there) and lands on the other side of a bf16
rounding boundary, and where a reduction over the batch runs in another
order (JAX reduces a broadcast's cotangent in bf16, adding one row at a
time; PyTorch sums in fp32 and rounds once).

Tolerances, each measured on these inputs and written beside its test:

- a transform (``fwht``): each element within one bf16 ulp of JAX's, or
  within ``2^-14`` of its row's max (a sum that cancels to near zero,
  where the fp32 order shows through), and at most 0.1% of the elements
  differing (measured: bit-equal to D = 1024; 0.005% from D = 2048);
- a product's output ``y`` and ``dx`` (a flip in ``i1`` cascades through the
  second transform): within ``2^-7`` of the output's max (the bf16 nets'
  bound) and at most 1% of the elements differing (measured: bit-equal to
  D = 256; at D = 4096 up to 2.9e-3 of the max, 0.4% of the elements;
  a ``dx`` summed over the stack axis is a reduction, below);
- a reduction over the batch (the diagonals' gradients, ``dx`` of the
  stacked matrix): within ``2^-5`` of its max, a few bf16 ulps of it
  (measured: up to 1.6e-2, two ulps, at the shapes here).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import whvi_tpu.ops.hadamard as jax_hadamard
import whvi_tpu.ops.whvi_op as jax_whvi_op
from whvi_tpu.models import WHVILinear as JaxWHVILinear
from whvi_tpu.models import WHVIRegression as JaxWHVIRegression
from whvi_tpu.models import relu as jax_relu
from whvi_tpu.ops.fwht_pallas import whvi_mul_pallas
from whvi_tpu.ops.hadamard import fwht_kron as jax_fwht_kron
from whvi_tpu.train import decayed_adam as jax_decayed_adam
from whvi_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

from whvi_tpu_torch.convert import (
    export_adam,
    export_params,
    host_array,
    load_jax_adam,
    load_jax_checkpoint,
    load_jax_params,
)
from whvi_tpu_torch.experiments import run_scaling
from whvi_tpu_torch.models import WHVILinear
from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops.hadamard import fwht, round_scalar
from whvi_tpu_torch.ops.whvi_op import set_whvi_mul_precision, whvi_mul
from whvi_tpu_torch.train import OptaxAdam, TrainConfig, Trainer, decayed_adam
from whvi_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint, to_tensor

torch.set_num_threads(1)

BF16 = torch.bfloat16
FLIP_SHARE = 1e-3  # transforms: share of elements that may differ
CASCADE_TOL = 2.0**-7  # products: max |port - JAX| / max |JAX|
CASCADE_SHARE = 1e-2  # products: share of elements that may differ
REDUCTION_TOL = 2.0**-5  # reductions over the batch, of their max


@pytest.fixture(autouse=True)
def xla_highest():
    """JAX's bf16 storage path: backend "xla", FWHT at "highest"."""
    backend, precision = jax_whvi_op._BACKEND, jax_hadamard._DEFAULT_PRECISION
    jax_whvi_op.set_whvi_mul_backend("xla")
    jax_hadamard.set_fwht_precision("highest")
    yield
    jax_whvi_op.set_whvi_mul_backend(backend)
    jax_hadamard.set_fwht_precision(precision)


def bf16(*arrays):
    """The same bf16 values in both packages: JAX arrays and their port
    tensors (through the bits, exact)."""
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    return j, [to_tensor(np.asarray(a)) for a in j]


def f32(a) -> np.ndarray:
    return host_array(a) if torch.is_tensor(a) else np.asarray(a).astype(np.float32)


def ulp(a: np.ndarray) -> np.ndarray:
    """The bf16 spacing at |a| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0**-126)))
    return 2.0 ** (e - 7)


def assert_cascade(got, want, tol=CASCADE_TOL, share=CASCADE_SHARE):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= tol * np.abs(want).max(), diff.max() / np.abs(want).max()
    assert (diff > 0).mean() <= share, (diff > 0).mean()


# ------------------------------------------------------------ the transform


@pytest.mark.parametrize("D", [4, 64, 256, 1024, 2048, 4096])
def test_fwht_on_bf16_matches_jax(D):
    """The plain butterflies on bf16, fp32 inside and rounded once, against
    JAX ``fwht_kron`` on bf16 (its matmul order); K4's CPU path is the same
    function."""
    x = np.random.RandomState(D).randn(32, D)
    (xj,), (xt,) = bf16(x)
    want = f32(jax_fwht_kron(xj, precision="highest"))
    got = fwht(xt)
    assert got.dtype == BF16
    assert torch.equal(fc.fwht_raw(xt), got)
    got = f32(got)
    diff = np.abs(got - want)
    row_max = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all((diff <= ulp(want)) | (diff <= 2.0**-14 * row_max))
    assert (diff > 0).mean() <= FLIP_SHARE
    if D <= 1024:  # measured: every sum exact in fp32 at these widths
        assert np.array_equal(got, want)


def test_fwht_on_bf16_rounds_once():
    """The repaired fault: the transform of bf16 is the fp32 transform
    rounded once, not rounded after each of the log2 D stages."""
    x = np.random.RandomState(0).randn(16, 4096)
    xt = torch.from_numpy(x.astype(np.float32)).to(BF16)
    assert torch.equal(fwht(xt), fwht(xt.float()).to(BF16))


# -------------------------------------------------------------- whvi_mul

# (s1/s2 lead, u lead, x lead, per_example) at each D
SHAPES = {
    "square": ((), (), (16,), False),
    "stacked": ((4,), (4,), (16, 1), False),
    "per_example": ((), (3, 16), (3, 16), True),
    "samples": ((), (3, 1), (3, 16), False),
}


def _product_inputs(name, D, seed=1):
    s_lead, u_lead, x_lead, per_example = SHAPES[name]
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*lead, D) for lead in (s_lead, u_lead, s_lead, x_lead)]
    return (*bf16(*arrays), per_example, rng)


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("D", [16, 256, 4096])
def test_whvi_mul_on_bf16_matches_jax(name, D):
    """Forward and backward (``jax.vjp``) at the square, stacked,
    per-example-noise and per-sample shapes."""
    J, T, per_example, rng = _product_inputs(name, D)
    want = jax_whvi_op.whvi_mul(*J)
    got = whvi_mul(*T, per_example=per_example)
    assert got.dtype == BF16
    assert_cascade(got, want)
    if D <= 256:  # measured: bit for bit
        assert np.array_equal(f32(got), f32(want))
    (g,), (gt,) = bf16(rng.randn(*want.shape))
    _, vjp = jax.vjp(jax_whvi_op.whvi_mul, *J)
    leaves = [a.clone().requires_grad_() for a in T]
    grads = torch.autograd.grad(whvi_mul(*leaves, per_example=per_example), leaves, gt)
    for i, (a, b) in enumerate(zip(grads, vjp(g))):
        assert a.dtype == BF16 and a.shape == b.shape
        reduced = i < 3 or name == "stacked"  # dx summed over the stack axis
        if reduced:
            assert_cascade(a, b, REDUCTION_TOL, share=1.0)
        else:
            assert_cascade(a, b)


def test_whvi_mul_on_bf16_replicas_match_jax_vmap():
    """The replica-stacked product against JAX's vmap over replicas: bit
    for bit (no reduction, D = 64)."""
    D, R = 64, 3
    rng = np.random.RandomState(2)
    J, T = bf16(*(rng.randn(R, 1, D) for _ in range(3)), rng.randn(R, 8, D))
    want = jax.vmap(lambda s1, u, s2, x: jax_whvi_op.whvi_mul(s1[0], u[0], s2[0], x))(*J)
    got = whvi_mul(*T, replicated=True)
    assert np.array_equal(f32(got), f32(want))


def test_repaired_rounding_at_4096():
    """The fault repaired: at D = 4096 (B = 16, seed 0) the product on
    bf16 leaves came 1.09e-2 of the max from JAX's, its butterflies rounding
    to bf16 after each stage. Rounded once a transform it is within 2^-10
    of the max, with at most 0.1% of the elements differing (measured:
    8.9e-5, 0.01%)."""
    rng = np.random.RandomState(0)
    J, T = bf16(rng.randn(4096), rng.randn(4096), rng.randn(4096), rng.randn(16, 4096))
    assert_cascade(whvi_mul(*T), jax_whvi_op.whvi_mul(*J), tol=2.0**-10, share=1e-3)


def test_mixed_dtypes_raise():
    d = torch.ones(16)
    with pytest.raises(TypeError):
        whvi_mul(d, d, d.to(BF16), torch.ones(2, 16))
    with pytest.raises(TypeError):
        fc.fused_raw(d, d, d, torch.ones(2, 16, dtype=BF16), False)


# ------------------------------------------------------------ the refusals


def test_bf16_precision_on_bf16_storage_raises_in_the_port():
    """The port refuses the bf16 precision on bf16 storage wherever the
    JAX "pallas" backend would reach its kernel (the next test), and
    run_scaling refuses ``--dtype bf16 --precision bf16``."""
    (_,), (d,) = bf16(np.ones(16))
    x = torch.ones(4, 16, dtype=BF16)
    with pytest.raises(ValueError, match="Pallas"):
        whvi_mul(d, d, d, x, precision="bf16")
    with pytest.raises(ValueError, match="Pallas"):
        fc.fused_raw(d, d, d, x, False, "bf16")
    with pytest.raises(ValueError, match="Pallas"):
        fc.fused_bwd_raw(d, d, d, x, "bf16")
    set_whvi_mul_precision("bf16")
    try:
        with pytest.raises(ValueError):
            whvi_mul(d, d, d, x)
        # a stacked product never reaches the Pallas kernel: fp32, as in JAX
        s = torch.ones(2, 16, dtype=BF16)
        assert whvi_mul(s, s, s, x[:, None, :]).dtype == BF16
    finally:
        set_whvi_mul_precision("fp32")
    with pytest.raises(ValueError):
        run_scaling.run(16, device="cpu", dtype="bf16", precision="bf16", steps=1)
    with pytest.raises(ValueError):
        run_scaling.main(["--dtype", "bf16", "--precision", "bf16"])


def test_jax_pallas_kernel_raises_on_bf16():
    """The limit of the reference the port mirrors: the JAX Pallas product
    cannot store bf16 (in interpret mode it raises at its output stores).
    If this test fails, JAX gained bf16 storage in its kernel, and the
    port's refusal above should be revisited."""
    J, _ = bf16(*(np.ones(16) for _ in range(3)), np.ones((4, 16)))
    with pytest.raises(Exception, match="(?i)dtype"):
        jax.block_until_ready(whvi_mul_pallas(*J, True))


# ------------------------------------------------------- the narrow net


def _nets(D=64, S=2):
    """The scaling net at width D (D -> D -> D -> 1) in both packages."""
    jnet = JaxWHVIRegression(
        [
            JaxWHVILinear(D, D, lambda_=3.0, s_init="auto"),
            jax_relu,
            JaxWHVILinear(D, D, lambda_=3.0, s_init="auto"),
            jax_relu,
            JaxWHVILinear(D, 1, s_init="auto"),
        ],
        train_samples=S,
    )
    return jnet, run_scaling.build_net(D, S, dtype=BF16)


def _flat(tree) -> list:
    return jax.tree_util.tree_leaves(tree)


def test_scaling_net_step_matches_jax():
    """The scaling net at D = 64 (S = 2, batch 8) in bf16, on the same
    parameters, data and noise: the loss, every gradient and one decayed
    Adam step (parameters and both moments, bf16 on both sides) against a
    JAX step built from the JAX Trainer's pieces (its loss on given noise,
    its ``decayed_adam`` and ``optax.apply_updates``)."""
    D, S, B = 64, 2, 8
    jnet, pnet = _nets(D, S)
    jparams = jnet.init(jax.random.PRNGKey(3), jnp.bfloat16)
    trainer = Trainer(pnet, TrainConfig(), device="cpu")
    state = trainer.init(0)
    load_jax_params(pnet, jparams)
    assert isinstance(state.optimizer, OptaxAdam)
    rng = np.random.RandomState(4)
    (xj, yj), _ = bf16(rng.randn(B, D), rng.randn(B, 1))
    X, y = run_scaling.data(D, B, 4, "cpu", BF16)
    assert np.array_equal(f32(X), f32(xj)) and np.array_equal(f32(y), f32(yj))
    eps = [
        rng.randn(S, 1, *layer.matrix.g_mu.shape) if isinstance(layer, WHVILinear) else None
        for layer in pnet.layers
    ]
    eps_j = [None if e is None else jnp.asarray(e, jnp.bfloat16) for e in eps]

    def jax_loss(params):
        preds = []
        for s in range(S):
            h = xj
            for layer, p, e in zip(jnet.layers, params["layers"], eps_j):
                if e is None:
                    h = layer.apply(p, h, None)
                else:
                    g = p["g_mu"] + jax.nn.softplus(p["g_rho"]) * e[s, 0]
                    h = layer.apply_given_g(p, h, g)
            preds.append(h)
        mnll = jnet.likelihood.mnll(params["likelihood"], yj, jnp.stack(preds), B)
        return mnll + jnet.kl(params)

    jloss, jgrads = jax.value_and_grad(jax_loss)(jparams)
    pnet.zero_grad()
    loss, aux = pnet.loss(X, y, B, eps=[None if e is None else to_tensor(np.asarray(a))
                                        for e, a in zip(eps, eps_j)])
    loss.backward()
    # JAX's activations add a float32 zero into the KL: the loss is float32
    assert aux["mnll"].dtype == BF16 and loss.dtype == torch.float32
    assert jloss.dtype == jnp.float32
    # the loss is bit for bit JAX's (measured so at ten seeds); the
    # gradients are reductions over batch and samples (measured: up to
    # 1.9e-2 of a leaf's max)
    assert np.float32(loss.item()) == np.float32(jloss)
    grads = jax.tree.map(lambda p: p.grad, {"layers": tuple(
        {k: getattr(l.matrix, k) for k in ("s1", "s2", "g_mu", "g_rho")}
        if isinstance(l, WHVILinear) else {} for l in pnet.layers
    ), "likelihood": {"rho": pnet.likelihood.rho}})
    for a, b in zip(_flat(grads), _flat(jgrads)):
        assert a.dtype == BF16
        assert_cascade(a, b, REDUCTION_TOL, share=1.0)

    # one decayed-Adam step from the same gradients, bf16 moments
    tx = jax_decayed_adam()
    opt_state = tx.init(jparams)
    updates, opt_state = tx.update(jgrads, opt_state, jparams)
    new_jparams = optax.apply_updates(jparams, updates)
    for a, b in zip(_flat(grads), _flat(jgrads)):  # the same gradients
        a.copy_(to_tensor(np.asarray(b)))
    state.optimizer.step()
    state.scheduler.step()
    for a, b in zip(_flat(export_params(pnet)), _flat(new_jparams)):
        assert np.array_equal(a, f32(b))
    (count, mu, nu), (sched,) = export_adam(pnet, state.optimizer, state.scheduler)
    assert count == 1 and sched == 1
    jadam = opt_state[0]
    assert jadam.mu["layers"][0]["s1"].dtype == jnp.bfloat16
    for a, b in zip(_flat(mu) + _flat(nu), _flat(jadam.mu) + _flat(jadam.nu)):
        assert np.array_equal(a, f32(b))
    for p in pnet.parameters():
        assert state.optimizer.state[p]["exp_avg"].dtype == BF16


def test_optax_adam_matches_optax_bit_for_bit():
    """Five steps of the same bf16 gradients through OptaxAdam and optax's
    decayed Adam, a fast decay making the schedule visible: parameters and
    moments equal bit for bit after each step."""
    lr0, gamma, p = 0.05, 0.5, 0.3
    rng = np.random.RandomState(0)
    (jp,), (tp,) = bf16(rng.randn(64))
    param = torch.nn.Parameter(tp.clone())
    opt, sched = decayed_adam([param], lr0, gamma, p)
    tx = jax_decayed_adam(lr0, gamma, p)
    st = tx.init(jp)
    for _ in range(5):
        (g,), (gt,) = bf16(rng.randn(64) * 10.0 ** rng.uniform(-6, 1))
        updates, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, updates)
        param.grad = gt
        opt.step()
        sched.step()
        assert np.array_equal(f32(param), f32(jp))
        assert np.array_equal(f32(opt.state[param]["exp_avg"]), f32(st[0].mu))
        assert np.array_equal(f32(opt.state[param]["exp_avg_sq"]), f32(st[0].nu))


def test_fp32_parameters_keep_torch_adam():
    opt, _ = decayed_adam([torch.nn.Parameter(torch.ones(3))])
    assert type(opt) is torch.optim.Adam


# --------------------------------------------------------------- convert


def test_convert_bf16_round_trip(tmp_path):
    """bf16 parameters and Adam state in from JAX and out again without a
    rounding, and a JAX bf16 checkpoint loaded into the port."""
    jnet, pnet = _nets(16, 2)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.bfloat16)
    load_jax_params(pnet, jax.tree.map(np.asarray, jparams))
    out = export_params(pnet)
    for a, b in zip(_flat(out), _flat(jparams)):
        assert a.dtype == np.float32 and np.array_equal(a, f32(b))
    back = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), out)
    assert all(np.array_equal(f32(a), f32(b)) for a, b in zip(_flat(back), _flat(jparams)))

    tx = jax_decayed_adam()
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.25), jparams)
    _, opt_state = tx.update(grads, tx.init(jparams), jparams)
    opt, sched = decayed_adam(pnet.parameters())
    load_jax_adam(pnet, opt, sched, opt_state)
    (count, mu, nu), (sched_count,) = export_adam(pnet, opt, sched)
    assert count == 1 and sched_count == 1
    for a, b in zip(_flat(mu) + _flat(nu), _flat(opt_state[0].mu) + _flat(opt_state[0].nu)):
        assert np.array_equal(a, f32(b))
    assert all(s["exp_avg"].dtype == BF16 for s in opt.state.values())

    path = str(tmp_path / "ckpt-1.npz")
    jstate = (jparams, opt_state, jax.random.PRNGKey(1), jnp.int32(7))
    jax_save_checkpoint(path, jstate)
    _, fresh = _nets(16, 2)
    meta = load_jax_checkpoint(fresh, path)
    assert meta["step"] == 7
    for a, b in zip(_flat(export_params(fresh)), _flat(jparams)):
        assert np.array_equal(a, f32(b))


def test_bf16_training_state_resumes_bit_for_bit(tmp_path):
    """The port's own checkpoint of a bf16 run: bf16 leaves saved as their
    bits, as JAX saves them, and restored exactly."""
    _, pnet = _nets(16, 2)
    trainer = Trainer(pnet, TrainConfig(), device="cpu")
    state = trainer.init(0)
    X, y = run_scaling.data(16, 8, 0, "cpu", BF16)
    trainer.train_step(state, X, y, 8, True)
    path = save_checkpoint(str(tmp_path / "ckpt-1.npz"), trainer.state_tree(state))
    with np.load(path) as saved:
        assert any(saved[k].dtype == np.dtype("V2") for k in saved.files)
    tree, _ = restore_checkpoint(path, trainer.state_tree(state))
    for a, b in zip(_flat(tree["params"]), trainer.state_tree(state)["params"]):
        assert a.dtype == BF16 and torch.equal(a, b)
    for a, b in zip(tree["exp_avg"], trainer.state_tree(state)["exp_avg"]):
        assert torch.equal(a, b)
    # a second trainer resumed from the file takes the same next step
    _, other = _nets(16, 2)
    resumed = Trainer(other, TrainConfig(), device="cpu")
    rstate = resumed.init(1)
    resumed.restore(path, rstate)
    trainer.train_step(state, X, y, 8, True)
    resumed.train_step(rstate, X, y, 8, True)
    for a, b in zip(pnet.parameters(), other.parameters()):
        assert torch.equal(a, b)


# ----------------------------------------------------------- run_scaling


@pytest.mark.parametrize("predict", [False, True])
def test_run_scaling_bf16_on_the_cpu(predict):
    rows = run_scaling.run(64, device="cpu", batch=8, samples=2, steps=3, dtype="bf16",
                           predict=predict)
    assert len(rows) == 1 and run_scaling.finite(rows[0])
    assert rows[0]["dtype"] == "bf16" and rows[0]["max_memory_gb"] is None


def test_run_scaling_data_round_as_jax():
    """bf16 data equal ``jnp.asarray(rng.randn(..), jnp.bfloat16)`` bit for
    bit (through float32, as JAX rounds it)."""
    X, y = run_scaling.data(32, 16, 5, "cpu", BF16)
    rng = np.random.RandomState(5)
    want = [jnp.asarray(rng.randn(16, 32), jnp.bfloat16), jnp.asarray(rng.randn(16, 1), jnp.bfloat16)]
    assert np.array_equal(f32(X), f32(want[0])) and np.array_equal(f32(y), f32(want[1]))


def test_scalars_round_as_jax_weak_types():
    assert round_scalar(math.log(2 * math.pi), BF16) == float(
        jnp.asarray(math.log(2 * math.pi), jnp.bfloat16))
    assert round_scalar(0.1, BF16) == float(jnp.asarray(0.1, jnp.bfloat16))


def test_likelihood_constants_round_as_jax():
    """The Gaussian log density and the heteroscedastic split on bf16: the
    Python constants beside bf16 arrays round to bf16 as JAX's weak types
    do, so both equal JAX's bit for bit."""
    from whvi_tpu.models import HeteroscedasticGaussianLikelihood as JaxHetero
    from whvi_tpu.models import GaussianLikelihood as JaxGaussian

    from whvi_tpu_torch.models import GaussianLikelihood, HeteroscedasticGaussianLikelihood

    rng = np.random.RandomState(6)
    (y, y_hat), (yt, y_hatt) = bf16(rng.randn(8, 2), rng.randn(3, 8, 2))
    mean, sigma = HeteroscedasticGaussianLikelihood(sigma0=0.3).split(y_hatt)
    jmean, jsigma = JaxHetero(sigma0=0.3).split(y_hat)
    assert np.array_equal(f32(mean), f32(jmean)) and np.array_equal(f32(sigma), f32(jsigma))
    lik = GaussianLikelihood(0.7, dtype=BF16)
    jlik = JaxGaussian(0.7)
    jp = jlik.init(jnp.bfloat16)
    assert np.array_equal(f32(lik.rho), f32(jp["rho"]))
    got = lik.mnll(yt, y_hatt, 100)
    want = jlik.mnll(jp, y, y_hat, 100)
    assert got.dtype == BF16 and np.array_equal(f32(got), f32(want))


def test_dtype_reaches_every_parameter_and_buffer():
    net = run_scaling.build_net(32, 2, dtype=BF16)
    assert {p.dtype for p in net.parameters()} == {BF16}
    assert {b.dtype for b in net.buffers()} == {BF16}  # the column head's H_rows
    X, y = run_scaling.data(32, 4, 0, "cpu", BF16)
    with torch.no_grad():
        assert net.predict(X, 2).dtype == BF16


def test_vector_bytes_of_bf16_rows():
    """bf16 rows start on 16 bytes, less only where a whole row is shorter."""
    assert [fc.vector_bytes(D, 2) for D in (2, 4, 8, 16, 4096)] == [4, 8, 16, 16, 16]
    assert fc.vector_bytes(4096) == 16
