"""The port's ``(data, sample)`` mesh (``whvi_tpu_torch/parallel/``) in a
4-rank gloo world on the CPU, at the layouts (1, 4), (2, 2) and (4, 1).

One world (``torch_parallel_worlds.loss_world``) runs every case; each
test asserts one case against the one-device port on the same generator
seed (loss rel <= 1e-6, gradients <= 1e-5 of their max, k-step parameters
<= 1e-5) and, for given global noise, against the JAX package's
one-device MC-ELBO from its public pieces (``_jax_loss``, as in
``tests/test_torch_models.py``; JAX's own ``test_parallel.py`` ties that
to its sharded estimator). The bf16 case is the bf16 operand precision
(the JAX ``"pallas"`` backend), held to the one-device port with the same
tolerances (the same kernels' rounding) and to JAX in interpret mode
within ``bf16_tol(16)``. The bf16s case is bf16 storage: each rank rounds
its partial gradient to bf16 before the fp32 sum, where one device rounds
the whole sum once, so a step's loss and gradient (over the largest
gradient) are held at ``BF16S_TOL`` (set from the readings; the
all-reduce's float32 payload is asserted apart), to JAX's one device on given
noise at ``test_torch_bf16_storage``'s 2^-7, and the gap is measured
beside JAX's own (``shard_map``'s bf16 psum on 4 of the 8 CPU devices).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worlds as w
from whvi_tpu.models import WHVILinear as JaxWHVILinear
from whvi_tpu.models import WHVIRegression as JaxWHVIRegression
from whvi_tpu.models import relu as jax_relu
from whvi_tpu.ops import hadamard as jax_hadamard
from whvi_tpu.ops import whvi_op as jax_whvi_op
from whvi_tpu.parallel import make_mesh as jax_make_mesh
from whvi_tpu.parallel import sharded_loss_fn as jax_sharded_loss_fn
from whvi_tpu_torch.convert import export_params
from whvi_tpu_torch.experiments import run_scaling
from whvi_tpu_torch.ops import set_whvi_mul_precision
from whvi_tpu_torch.ops.fwht_cuda import bf16_tol
from whvi_tpu_torch.parallel.distributed import spawn
from whvi_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(1)

LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
PARAM_TOL = 1e-5
JAX_TOL = 1e-5
# bf16 storage, a step against one device: the float32 loss and the
# gradient over the largest gradient (measured: at most 5.6e-6 and 8.5e-6;
# JAX's own mesh 2.1e-4, from its bf16 reductions inside the step)
BF16S_TOL = 1e-4
BF16S_ULP = 2.0**-7  # the MNLL is a bf16 scalar: within one bf16 ulp of it
BF16S_FAULT = 2.0**-7  # a gap above both this and twice JAX's is a fault
BF16S_JAX_TOL = 2.0**-7  # bf16 storage against JAX's: test_torch_bf16_storage's CASCADE_TOL


def _f64(a) -> np.ndarray:
    return np.asarray(a.double() if torch.is_tensor(a) else a, dtype=np.float64)


def rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def world():
    return spawn(w.loss_world, w.WORLD, "gloo", "cpu")


def _one_device(case):
    """The one-device port: loss, gradients and predictions at the
    world's generator seeds."""
    set_whvi_mul_precision("bf16" if case == "bf16" else "fp32")
    try:
        net = w.build_net(case)
        x, y, weights = w.batch(case)
        loss, aux = net.loss(x, y, w.N, torch.Generator().manual_seed(5), kl_scale=w.KL_SCALE,
                             weights=weights)
        loss.backward()
        with torch.no_grad():
            y_hat = net.predict(x, w.S, torch.Generator().manual_seed(6))
    finally:
        set_whvi_mul_precision("fp32")
    return float(loss.detach()), float(aux["mnll"].detach()), [p.grad for p in net.parameters()], y_hat


@pytest.mark.parametrize("case", w.CASES)
@pytest.mark.parametrize("layout", w.LAYOUTS)
def test_sharded_loss_and_grads_match_one_device(world, layout, case):
    got = world[0][(layout, case)]
    loss, mnll, grads, _ = _one_device(case)
    if case == "bf16s":
        assert abs(got["loss"] - loss) <= BF16S_TOL * abs(loss)
        assert abs(got["mnll"] - mnll) <= BF16S_ULP * abs(mnll)
        assert grad_gap(got["grads"], grads) <= BF16S_TOL
    else:
        assert abs(got["loss"] - loss) <= LOSS_TOL * abs(loss)
        assert abs(got["mnll"] - mnll) <= LOSS_TOL * abs(mnll)
        for g, want in zip(got["grads"], grads):
            assert rel_err(g, want) <= GRAD_TOL
    assert got["collectives"] == 1  # one all-reduce carries gradients and MNLL
    # in float32 whatever the storage: bf16 partials are summed in fp32
    # and rounded once (a bf16 sum stays inside BF16S_TOL on this net)
    assert got["reduced"] == ["torch.float32"]
    assert got["same_loss"]
    assert all(r[(layout, case)]["loss"] == got["loss"] for r in world)


@pytest.mark.parametrize("case", w.CASES)
@pytest.mark.parametrize("layout", w.LAYOUTS)
def test_sharded_predict_matches_one_device(world, layout, case):
    got = world[0][(layout, case)]["y_hat"]
    want = _one_device(case)[3]
    assert got.shape == (w.S, w.B, want.shape[-1])
    assert rel_err(got, want) <= GRAD_TOL
    if case in ("per_example", "weighted", "column"):
        # per-example noise: rows of one sample differ, so no data shard
        # repeated another's noise
        assert not torch.equal(got[:, 0], got[:, w.B // 2])


def _jax_net(case):
    """The JAX twin of ``w.build_net(case)`` (cases without a column head)
    and its parameters."""
    pnet = w.build_net(case)
    pe = case in ("per_example", "weighted")
    jnet = JaxWHVIRegression(
        [JaxWHVILinear(13, 16, 3.0, per_example_noise=pe), jax_relu,
         JaxWHVILinear(16, 16, 3.0, per_example_noise=pe), jax_relu,
         JaxWHVILinear(16, 2, 1e-5, per_example_noise=pe)],
        train_samples=w.S,
    )
    params = jax.tree.map(jnp.asarray, export_params(pnet))
    if case == "bf16s":
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    return pnet, jnet, params


def _jax_loss(jnet, params, x, y, eps, weights):
    """The MC-ELBO from the JAX package's public pieces, one pass a sample
    on the given global noise (``(S, 1, ...)`` shared or ``(S, B, ...)`` per
    example)."""
    preds = []
    for s in range(w.S):
        h = x
        for layer, p, e in zip(jnet.layers, params["layers"], eps):
            if e is None:
                h = layer.apply(p, h, None)
            else:
                g = p["g_mu"] + jax.nn.softplus(p["g_rho"]) * (e[s, 0] if e.shape[1] == 1 else e[s])
                h = layer.apply_given_g(p, h, g)
        preds.append(h)
    y_hat = jnp.stack(preds)
    mnll = jnet.likelihood.mnll(params["likelihood"], y, y_hat, w.N, weights=weights)
    return mnll + w.KL_SCALE * jnet.kl(params), y_hat


def _jnp(t):
    """A port tensor as a JAX array of its dtype (bf16 through fp32, exact)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("case", ("shared", "per_example", "weighted", "bf16", "bf16s"))
@pytest.mark.parametrize("layout", w.LAYOUTS)
def test_sharded_loss_matches_jax_for_given_noise(world, layout, case):
    got = world[0][(layout, case)]
    pnet, jnet, params = _jax_net(case)
    x, y, weights = w.batch(case)
    eps = [None if e is None else _jnp(e) for e in w.given_eps(pnet)]
    backend, precision = jax_whvi_op._BACKEND, jax_hadamard.get_fwht_precision()
    jax_whvi_op.set_whvi_mul_backend("pallas" if case == "bf16" else "xla")
    if case == "bf16s":  # JAX's bf16 storage path (its Pallas kernels raise on bf16)
        jax_hadamard.set_fwht_precision("highest")
    try:
        loss, y_hat = _jax_loss(jnet, params, _jnp(x), _jnp(y), eps,
                                None if weights is None else _jnp(weights))
    finally:
        jax_whvi_op.set_whvi_mul_backend(backend)
        jax_hadamard.set_fwht_precision(precision)
    tol = {"bf16": bf16_tol(16), "bf16s": BF16S_JAX_TOL}.get(case, JAX_TOL)
    assert abs(got["loss_eps"] - float(loss)) <= tol * abs(float(loss))
    assert rel_err(got["y_hat_eps"], y_hat) <= tol


def grad_gap(got, want) -> float:
    """max |got - want| over every parameter's gradient, over the largest
    |want| of all (smoke phase 11's reading of a step)."""
    scale = max(np.max(np.abs(_f64(g))) for g in want)
    return float(max(np.max(np.abs(_f64(a) - _f64(b))) for a, b in zip(got, want)) / scale)


def _jax_bf16s_gap(layout) -> tuple[float, float]:
    """JAX's own bf16-storage mesh against one device: the loss (relative)
    and the gradient (``grad_gap``) of ``sharded_loss_fn`` on 4 of the 8
    CPU devices against ``net.loss`` on one, the same key. The noise is per
    batch, so JAX keeps its keys on the mesh and the two are one estimator;
    its replicated bf16 parameters get a bf16 psum of the shards'
    cotangents."""
    _, jnet, params = _jax_net("bf16s")
    x, y = (_jnp(t) for t in w.batch("bf16s")[:2])
    key = jax.random.PRNGKey(w.SEED)
    mesh = jax_make_mesh(*layout, devices=jax.devices()[: w.WORLD])
    sharded = jax_sharded_loss_fn(jnet, mesh, w.S)
    backend, precision = jax_whvi_op._BACKEND, jax_hadamard.get_fwht_precision()
    jax_whvi_op.set_whvi_mul_backend("xla")
    jax_hadamard.set_fwht_precision("highest")
    try:
        l_mesh, g_mesh = jax.jit(jax.value_and_grad(
            lambda p: sharded(p, key, x, y, w.N, w.KL_SCALE)[0]))(params)
        l_one, g_one = jax.jit(jax.value_and_grad(
            lambda p: jnet.loss(p, key, x, y, w.N, kl_scale=w.KL_SCALE)[0]))(params)
    finally:
        jax_whvi_op.set_whvi_mul_backend(backend)
        jax_hadamard.set_fwht_precision(precision)
    assert all(g.dtype == jnp.bfloat16 for g in jax.tree.leaves(g_mesh))
    f32 = lambda tree: [np.asarray(g, np.float32) for g in jax.tree.leaves(tree)]
    loss_gap = abs(float(l_mesh) / float(l_one) - 1.0)
    return loss_gap, grad_gap(f32(g_mesh), f32(g_one))


def test_bf16_storage_mesh_rounding_against_jax(world):
    """Each package's bf16-storage mesh against its own one device, one
    step: the port's gap may not exceed twice JAX's where it is above
    2^-7 (a fault if it did: the port would round further from one device
    than the reference does). Prints one JSON row a layout."""
    loss, _, grads, _ = _one_device("bf16s")
    for layout in w.LAYOUTS:
        got = world[0][(layout, "bf16s")]
        port = grad_gap(got["grads"], grads)
        jax_loss_gap, jax_gap = _jax_bf16s_gap(layout)
        print(json.dumps({
            "layout": layout, "port_grad_gap": port, "jax_grad_gap": jax_gap,
            "port_loss_gap": abs(got["loss"] / loss - 1.0), "jax_loss_gap": jax_loss_gap,
        }))
        assert np.isfinite(jax_gap) and jax_loss_gap <= BF16S_FAULT
        assert port <= max(2 * jax_gap, BF16S_FAULT)


def _steps_one_device(k_true):
    x, y, _ = w.batch("per_example")
    trainer = Trainer(w.build_net("per_example"), TrainConfig(), "cpu")
    state = trainer.init(w.SEED)
    for k in range(1 + k_true):
        m = trainer.train_step(state, x, y, w.N, k > 0)
    return float(m["loss"]), w.flat_params(trainer.net)


@pytest.mark.parametrize("layout", w.LAYOUTS)
def test_scan_equals_k_steps_and_one_device(world, layout):
    got = world[0][(layout, "steps")]
    assert got["scan_loss"] == got["step_loss"]
    assert torch.equal(got["params"], got["params_k_steps"])
    assert got["same_params"]  # every rank applied the same reduced gradient
    loss, params = _steps_one_device(3)
    assert abs(got["scan_loss"] - loss) <= LOSS_TOL * abs(loss)
    assert rel_err(got["params"], params) <= PARAM_TOL


@pytest.mark.parametrize("layout", w.LAYOUTS)
def test_phase_flag_freezes_the_likelihood(world, layout):
    assert world[0][(layout, "steps")]["rho_frozen"]


@pytest.mark.parametrize("layout", w.LAYOUTS)
def test_noise_freeze_holds_the_noise_branch(world, layout):
    got = world[0][(layout, "freeze")]
    noise = got["noise"]
    assert torch.equal(noise[1], noise[0]) and torch.equal(noise[2], noise[0])
    assert not torch.equal(noise[3], noise[0])
    x, y, _ = w.batch("per_example")
    trainer = Trainer(w.split_head_net(), TrainConfig(noise_freeze_steps=2), "cpu")
    state = trainer.init(w.SEED)
    for _ in range(3):
        trainer.train_step(state, x, y[:, :1], w.N, True)
    assert rel_err(got["params"], w.flat_params(trainer.net)) <= PARAM_TOL


@pytest.mark.parametrize("mode", ["train", "predict"])
def test_run_scaling_rows_on_a_mesh(world, mode):
    got = world[0]["run_scaling"]
    assert not isinstance(got, str), got
    rows = [r for r in got if r.get("mode", "train") == mode]
    assert len(rows) == 1
    row = rows[0]
    assert row["mesh"] == {"data": 2, "sample": 2}
    assert row["backend"] == "gloo" and row["ranks_per_card"] is None
    assert row["device"] == "cpu" and run_scaling.finite(row)
    key = "step_ms" if mode == "train" else "call_ms"
    # every rank reads the slowest rank's times
    assert {r[key] for rank in world for r in rank["run_scaling"] if key in r} == {row[key]}


def test_run_scaling_refuses_a_mesh_of_other_rank_count():
    with pytest.raises(SystemExit):
        run_scaling.main(["--force-cpu-devices", "3", "--mesh", "2x2", "--sizes", "64"])
    with pytest.raises(SystemExit):
        run_scaling.main(["--force-cpu-devices", "4", "--sizes", "64"])


@pytest.mark.parametrize(
    "what, text",
    [
        ("n_samples", "n_samples=6 not divisible by sample shards 4"),
        ("mesh_size", "need 8 devices for mesh (data=4, sample=2), have 4"),
        ("freeze_without_split_head", "Parallel"),
    ],
)
def test_refusals(world, what, text):
    message = world[0]["refusals"][what]
    assert message is not None and text in message, message
