"""Generate the toy-example notebook of the port, ``docs/toy_example_torch.ipynb``.

Counterpart of ``experiments/make_toy_notebook.py`` (the reference's
``Toy example.ipynb``): a degree-8 polynomial target with an unobserved
gap, non-Bayesian baselines, WHVI nets trained with and without the KL
term, predictive fans, and the parameter count. Its code cells import only
``whvi_tpu_torch`` (with numpy, torch and matplotlib) and run on
``DEVICE``, the card unless ``--device cpu`` is given. The notebook never
overwrites ``experiments/toy_example.ipynb``. ``nbformat`` is needed to
write it, ``nbclient`` to execute it (``--execute``).

Run: python -m whvi_tpu_torch.experiments.make_toy_notebook [--device cuda|cpu]
    [--execute] [--out PATH]
"""

from __future__ import annotations

import argparse
import os

__all__ = ["OUT", "build", "cells", "main"]

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "docs", "toy_example_torch.ipynb",
)


def cells(device: str = "cuda") -> list[tuple[str, str]]:
    """The notebook's cells in order, ``("markdown" | "code", source)``."""
    return [
        ("markdown", """# Walsh-Hadamard Variational Inference — toy example (PyTorch port)

The reference notebook (`Toy example.ipynb` in ltdung/WHVI) on
`whvi_tpu_torch`: a degree-8 polynomial target observed everywhere
*except* a gap `x ∈ [0.6, 1.4]`, fit with

1. non-Bayesian MLPs (cosine vs sigmoid features): point estimates,
2. a WHVI Bayesian network trained on the ELBO, whose predictive
   distribution should be **more uncertain inside the gap** (the
   paper's "in-between uncertainty" claim),
3. the same WHVI model with the KL term removed (ablation), which
   collapses to a point estimate and loses that property.

`DEVICE` below picks where it runs: `"cuda"` (the hand-written kernels
on the card) or `"cpu"` (the plain PyTorch versions of the kernels)."""),
        ("code", f"""import numpy as np
import matplotlib.pyplot as plt
import torch

from whvi_tpu_torch.data import polynomial_data
from whvi_tpu_torch.data.toy import polynomial_f
from whvi_tpu_torch.models import Dense, WHVILinear, WHVIRegression, cosine, sigmoid
from whvi_tpu_torch.train import TrainConfig, Trainer

DEVICE = torch.device({device!r})"""),
        ("markdown", """## The target

`f(x) = 0.50 - 3.45x + 1.14x² + 4.36x³ - ...`, the degree-8 polynomial the
reference solves for via a Vandermonde system (notebook cell 2;
report/model-testing.tex:16). 128 noisy observations, none inside the gap."""),
        ("code", """X, y = polynomial_data(seed=0)
xs = np.linspace(-1.05, 2.05, 400, dtype=np.float32).reshape(-1, 1)

plt.figure(figsize=(8, 4))
plt.plot(xs, polynomial_f(xs[:, 0]), "k--", lw=1, label="true f")
plt.scatter(X, y, s=12, alpha=0.7, label="observations")
plt.axvspan(0.6, 1.4, color="orange", alpha=0.15, label="unobserved gap")
plt.legend(); plt.xlabel("x"); plt.ylabel("y"); plt.title("Toy data")
plt.show()
print(f"n = {len(X)}, gap is empty: "
      f"{(~((X[:, 0] > 0.6) & (X[:, 0] < 1.4))).all()}")"""),
        ("markdown", """## Non-Bayesian baselines

Two 128-128 MLPs (cosine vs sigmoid activations), trained by plain
maximum likelihood (the reference's cells 5-14). They give point
predictions with no uncertainty."""),
        ("code", """def make_baseline(act):
    return WHVIRegression(
        [Dense(1, 128), act, Dense(128, 128), act, Dense(128, 1)],
        sigma0=0.1,
    )

def train(net, epochs=3000, seed=0, ignore_kl=False, **cfg_kw):
    cfg = TrainConfig(batch_size=128, epochs1=0, epochs2=epochs,
                      ignore_kl=ignore_kl, epochs_per_call=epochs, **cfg_kw)
    trainer = Trainer(net, cfg, device=DEVICE)
    state = trainer.init(seed)
    trainer.fit(state, X, y)
    return trainer

def generator(seed):
    return torch.Generator(device=DEVICE).manual_seed(seed)

baselines = {}
for name, act in [("cosine", cosine), ("sigmoid", sigmoid)]:
    trainer = train(make_baseline(act), epochs=3000)
    m = trainer.evaluate(X, y, generator(1))
    baselines[name] = (trainer, m)
    print(f"{name:8s} train RMSE = {m['rmse']:.4f}")"""),
        ("code", """plt.figure(figsize=(8, 4))
plt.plot(xs, polynomial_f(xs[:, 0]), "k--", lw=1, label="true f")
plt.scatter(X, y, s=8, alpha=0.4)
with torch.no_grad():
    for name, (trainer, _) in baselines.items():
        y_hat = trainer.net.predict(torch.from_numpy(xs).to(DEVICE), 1, generator(2))
        plt.plot(xs, y_hat[0].cpu().numpy(), label=f"{name} MLP")
plt.axvspan(0.6, 1.4, color="orange", alpha=0.15)
plt.ylim(-4, 8); plt.legend(); plt.title("Point-estimate baselines")
plt.show()"""),
        ("markdown", """## WHVI Bayesian network

`[WHVILinear(1,128, λ=1), sigmoid, WHVILinear(128,128, λ=2.5), sigmoid,
WHVILinear(128,1, λ=5)]` with `σ₀ = 0.1`, the reference notebook's KL
configuration (cell 19). Its parameter count is 1537
(report/model-testing.tex:60; the paper says 1541)."""),
        ("code", """def make_whvi():
    return WHVIRegression(
        [
            WHVILinear(1, 128, lambda_=1.0, s_init="auto"),
            sigmoid,
            WHVILinear(128, 128, lambda_=2.5, s_init="auto",
                       per_example_noise=True),
            sigmoid,
            WHVILinear(128, 1, lambda_=5.0, s_init="auto"),
        ],
        sigma0=0.1,
        train_samples=4,
        eval_samples=64,
    )

n_params = sum(p.numel() for p in make_whvi().parameters())
print(f"parameter count: {n_params}")
assert n_params == 1537"""),
        ("code", """EPOCHS = 50500  # the reference protocol's 500 + 50000 (full batch)
trainer_kl = train(make_whvi(), epochs=EPOCHS, kl_warmup_steps=int(EPOCHS * 0.4))
m_kl = trainer_kl.evaluate(X, y, generator(1))
print(f"WHVI (with KL) train RMSE = {m_kl['rmse']:.4f}")

trainer_no = train(make_whvi(), epochs=EPOCHS, ignore_kl=True)
m_no = trainer_no.evaluate(X, y, generator(1))
print(f"WHVI (no KL)   train RMSE = {m_no['rmse']:.4f}")"""),
        ("markdown", """## Predictive fan charts

64 posterior samples per input; the fan shows the 5-95% predictive
quantiles (with the observation noise). The KL-trained model should
widen **inside the gap**; the no-KL ablation should not."""),
        ("code", """def fan(trainer, ax, title):
    with torch.no_grad():
        y_hat = trainer.net.predict(torch.from_numpy(xs).to(DEVICE), 64, generator(3))
        mu, sd = (t[:, 0].cpu().numpy() for t in trainer.net.likelihood.predict(y_hat))
    samples = y_hat[:, :, 0].cpu().numpy()
    lo, hi = np.quantile(samples, [0.05, 0.95], axis=0)
    ax.plot(xs, polynomial_f(xs[:, 0]), "k--", lw=1)
    ax.scatter(X, y, s=8, alpha=0.4)
    ax.fill_between(xs[:, 0], lo - 2 * sd.mean(), hi + 2 * sd.mean(),
                    alpha=0.2, label="5-95% + noise")
    ax.fill_between(xs[:, 0], lo, hi, alpha=0.35, label="5-95% posterior")
    ax.plot(xs, mu, lw=1.5, label="posterior mean")
    ax.axvspan(0.6, 1.4, color="orange", alpha=0.15)
    ax.set_ylim(-4, 8); ax.set_title(title); ax.legend(fontsize=8)

fig, axes = plt.subplots(1, 2, figsize=(13, 4.5), sharey=True)
fan(trainer_kl, axes[0], "WHVI (ELBO, with KL)")
fan(trainer_no, axes[1], "WHVI (no KL ablation)")
plt.show()"""),
        ("code", """def gap_vs_observed_sd(trainer):
    def sd_of(lo, hi):
        pts = np.linspace(lo, hi, 50, dtype=np.float32).reshape(-1, 1)
        with torch.no_grad():
            y_hat = trainer.net.predict(torch.from_numpy(pts).to(DEVICE), 64, generator(4))
        return float(y_hat.std(dim=0, unbiased=False).mean())
    return sd_of(0.7, 1.3), sd_of(-0.9, 0.5)

for name, trainer in [("with KL", trainer_kl), ("no KL  ", trainer_no)]:
    g, o = gap_vs_observed_sd(trainer)
    print(f"{name}: posterior sd in gap = {g:.3f}, observed region = {o:.3f},"
          f"  ratio = {g / max(o, 1e-9):.2f}")"""),
        ("markdown", """The KL-trained posterior is wider in the gap (ratio > 1) while the
no-KL model is equally (over)confident everywhere: the paper's
qualitative headline, with the paper-correct `W = S1·H·diag(g)·H·S2`
(the reference implementation's own W collapses to a diagonal matrix;
see SURVEY.md §0)."""),
    ]


def build(device: str = "cuda"):
    """The notebook (``nbformat`` v4) of :func:`cells`."""
    import nbformat as nbf

    nb = nbf.v4.new_notebook()
    make = {"markdown": nbf.v4.new_markdown_cell, "code": nbf.v4.new_code_cell}
    nb["cells"] = [make[kind](source) for kind, source in cells(device)]
    nb["metadata"]["kernelspec"] = {"display_name": "Python 3", "language": "python",
                                    "name": "python3"}
    return nb


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--execute", action="store_true", help="run it with nbclient first")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    import nbformat as nbf

    nb = build(args.device)
    if args.execute:
        from nbclient import NotebookClient

        root = os.path.dirname(os.path.dirname(OUT))
        NotebookClient(nb, timeout=3600, resources={"metadata": {"path": root}}).execute()
    with open(args.out, "w") as f:
        nbf.write(nb, f)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
