"""The report's four figures, from the port: their data as JSON wherever
this runs, and the PNG where ``matplotlib`` imports.

Counterpart of ``benchmarks/make_figures.py``. Outputs go to
``--out-dir`` (default ``docs/figures_torch/``), never to ``docs/figures/``:

1. ``toy_fan``: posterior-predictive fans on the degree-8 toy polynomial
   of the 1 -> 128 -> 128 -> 1 sigmoid net (``sigma0 = 0.1``, 4 MC samples
   in training, 128 in prediction), trained with and without the KL term,
   500 + 20000 epochs (500 + 2000 with ``--quick``). The with-KL net
   should be more uncertain in the data gap x in [0.6, 1.4]; its JSON
   holds each net's predictive mean and sd on 240 points and their mean
   sd in the gap (``gap_sd``). It trains through K2/K3 (the 128 x 128
   layer) and K4; its predictions go through K1.
2. ``fwht_crossover``: ``bench.fwht_sweep --plot`` (the FWHT against the
   dense matmul across D). Times come only from a card: with ``--cpu`` it
   is not drawn, and the output says so.
3. ``reliability``: nominal against empirical coverage of the pooled test
   z-scores of the UCI protocol on yacht, raw and temperature-calibrated
   (8 splits, 500 + 50000 epochs; 4 splits, 100 + 2000 with ``--quick``).
   Yacht's file is not in the repository (``data/README.md``): without it
   the protocol runs on ``run_vi_vs_hmc``'s synthetic fallback (308 x 6,
   ``y = sin(sum x)``), and the figure and its JSON say "synthetic".
4. ``sampler_rescue``: the ESS of each sampler on the over-trained
   mixed-lambda posterior, read from a port ``run_vi_vs_hmc --out`` JSON
   given by ``--study PATH`` (never the JAX capture
   ``docs/vi_vs_hmc.json``); without ``--study`` it is not drawn.

On the card unless ``--cpu``. Each figure prints one JSON line naming
what it wrote.

Run: python -m whvi_tpu_torch.bench.make_figures [--cpu] [--quick]
    [--only toy_fan|crossover|reliability|sampler_rescue] [--study PATH] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from whvi_tpu_torch.bench.common import device_name, emit

__all__ = ["FIGURES", "OUT_DIR", "fig_crossover", "fig_reliability", "fig_sampler_rescue",
           "fig_toy_fan", "main"]

OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "docs", "figures_torch",
)
FIGURES = ("toy_fan", "crossover", "reliability", "sampler_rescue")
GAP = (0.6, 1.4)
BLUE, ORANGE = "#2a78d6", "#eb6834"
INK, MUTED = "#222222", "#777777"


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None where matplotlib
    does not import."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style(ax):
    ax.grid(True, linewidth=0.3, alpha=0.35)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.tick_params(labelsize=8, colors=INK)


def _write(out_dir: str, name: str, data: dict, draw) -> dict:
    """Write ``name.json``; draw ``name.png`` with ``draw(plt)`` (a figure)
    where matplotlib imports. Returns and prints what was written."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(data, f)
    written = {"figure": name, "data": path, "png": None}
    plt = _pyplot()
    if plt is None:
        written["reason"] = "matplotlib does not import here"
    else:
        fig = draw(plt)
        written["png"] = os.path.join(out_dir, f"{name}.png")
        fig.savefig(written["png"], dpi=160)
        plt.close(fig)
    return emit(written)


def _toy_net():
    from whvi_tpu_torch.models import WHVILinear, WHVIRegression, sigmoid

    return WHVIRegression(
        [
            WHVILinear(1, 128, lambda_=1.0, s_init="auto"),
            sigmoid,
            WHVILinear(128, 128, lambda_=2.5, s_init="auto", per_example_noise=True),
            sigmoid,
            WHVILinear(128, 1, lambda_=5.0, s_init="auto"),
        ],
        sigma0=0.1,
        train_samples=4,
        eval_samples=128,
    )


def toy_fan_data(device, quick: bool = False, epochs: tuple[int, int] | None = None) -> dict:
    """Both nets' predictive mean and sd on 240 points of [-1.15, 1.95],
    and their mean predictive sd in the gap. ``epochs`` (phase 1, phase 2)
    replaces the figure's 500 + 20000 (500 + 2000 ``quick``)."""
    from whvi_tpu_torch.data import polynomial_data
    from whvi_tpu_torch.train import TrainConfig, Trainer

    X, y = polynomial_data(seed=0)
    epochs1, epochs2 = epochs or (500, 2000 if quick else 20000)
    total = epochs1 + epochs2
    xs = np.linspace(-1.15, 1.95, 240, dtype=np.float32)[:, None]
    in_gap = (xs[:, 0] >= GAP[0]) & (xs[:, 0] <= GAP[1])
    data = {"x": xs[:, 0].tolist(), "train_x": np.asarray(X)[:, 0].tolist(),
            "train_y": np.asarray(y)[:, 0].tolist(), "epochs": [epochs1, epochs2],
            "device": device_name(device), "gap": list(GAP), "gap_sd": {}}
    for key, ignore_kl in (("with_kl", False), ("no_kl", True)):
        cfg = TrainConfig(batch_size=128, epochs1=epochs1, epochs2=epochs2, ignore_kl=ignore_kl,
                          kl_warmup_steps=int(total * 0.4), epochs_per_call=500)
        trainer = Trainer(_toy_net(), cfg, device=device)
        state = trainer.init(0)
        trainer.fit(state, X, y)
        with torch.no_grad():
            y_hat = trainer.net.predict(torch.from_numpy(xs).to(device), 128,
                                        torch.Generator(device=device).manual_seed(7))
            mean, sd = (t[:, 0].cpu().numpy() for t in trainer.net.likelihood.predict(y_hat))
        data[key] = {"mean": mean.tolist(), "sd": sd.tolist()}
        data["gap_sd"][key] = float(sd[in_gap].mean())
    return data


def fig_toy_fan(out_dir: str, device, quick: bool = False,
                epochs: tuple[int, int] | None = None) -> dict:
    data = toy_fan_data(device, quick, epochs)

    def draw(plt):
        fig, axes = plt.subplots(1, 2, figsize=(9, 3.6), sharey=True)
        x1 = np.asarray(data["x"])
        for ax, key, title in ((axes[0], "with_kl", "ELBO (with KL)"),
                               (axes[1], "no_kl", "no-KL ablation")):
            mean, sd = np.asarray(data[key]["mean"]), np.asarray(data[key]["sd"])
            for z, alpha in ((1.96, 0.18), (0.674, 0.32)):  # 95% / 50% central fans
                ax.fill_between(x1, mean - z * sd, mean + z * sd, color=BLUE, alpha=alpha,
                                linewidth=0)
            ax.plot(x1, mean, color=BLUE, linewidth=2, label="predictive mean")
            ax.scatter(data["train_x"], data["train_y"], s=9, color=INK, alpha=0.55,
                       linewidths=0, label="train data", zorder=3)
            ax.axvspan(*GAP, color=MUTED, alpha=0.08, zorder=0)
            ax.set_title(title, fontsize=10, color=INK)
            ax.set_xlabel("x", fontsize=9, color=INK)
            _style(ax)
        axes[0].set_ylabel("y", fontsize=9, color=INK)
        axes[0].legend(fontsize=8, loc="upper left", frameon=True, framealpha=0.85,
                       edgecolor="none")
        fig.suptitle(f"Toy polynomial: in-between uncertainty needs the KL term "
                     f"({data['device']})", fontsize=11, color=INK)
        fig.tight_layout(rect=(0, 0, 1, 0.95))
        return fig

    return _write(out_dir, "toy_fan", data, draw)


def fig_crossover(out_dir: str, device, quick: bool = False) -> dict:
    """``fwht_sweep --plot`` on the card; its rows and crossover as JSON."""
    if device.type != "cuda":
        return emit({"figure": "fwht_crossover", "data": None, "png": None,
                     "reason": "times come only from a card (not drawn with --cpu)"})
    from whvi_tpu_torch.bench import fwht_sweep

    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "fwht_crossover.png")
    argv = ["--plot", png] + (["--iters", "20", "--sizes", "64", "256", "1024"] if quick else [])
    rows, crossover = fwht_sweep.main(argv)
    written = {"figure": "fwht_crossover", "data": os.path.join(out_dir, "fwht_crossover.json"),
               "png": png if os.path.exists(png) else None}
    with open(written["data"], "w") as f:
        json.dump({"rows": rows, "crossover_D": crossover}, f)
    return emit(written)


def fig_reliability(out_dir: str, device, quick: bool = False,
                    epochs: tuple[int, int] | None = None) -> dict:
    """``epochs`` (phase 1, phase 2) replaces the protocol's 500 + 50000
    (100 + 2000 ``quick``)."""
    from whvi_tpu_torch.evaluation import ProtocolConfig, evaluate_bayesian_regression
    from whvi_tpu_torch.experiments.run_vi_vs_hmc import _load_subset

    X, y, _, _, source = _load_subset(0, n_train=308)
    epochs1, epochs2 = epochs or ((100, 2000) if quick else (500, 50000))
    cfg = ProtocolConfig(
        n_splits=4 if quick else 8, epochs1=epochs1, epochs2=epochs2, bias=True, per_example_noise=True, train_samples=8,
        sigma0=0.1, calibrate=True, calib_frac=0.15, calib_pooled=True, checkpoint_every=0,
    )
    res = evaluate_bayesian_regression(X, y, cfg, device=device)
    data = {"source": source, "device": device_name(device),
            "epochs": [cfg.epochs1, cfg.epochs2], "n_splits": cfg.n_splits,
            "reliability_raw": res["reliability_raw"], "reliability_cal": res["reliability_cal"],
            "temperature_mean": res["temperature_mean"]}

    def draw(plt):
        fig, ax = plt.subplots(figsize=(4.6, 4.2))
        ax.plot([0, 1], [0, 1], color=MUTED, linewidth=0.8, linestyle="--",
                label="perfect calibration")
        for key, color, label in (("reliability_raw", ORANGE, "raw predictive"),
                                  ("reliability_cal", BLUE, "temperature-calibrated")):
            ax.plot([r["nominal"] for r in data[key]], [r["empirical"] for r in data[key]],
                    color=color, linewidth=2, marker="o", markersize=4, label=label)
        ax.set_xlabel("nominal central-interval level", fontsize=9, color=INK)
        ax.set_ylabel("empirical coverage (pooled test z)", fontsize=9, color=INK)
        name = "Yacht" if source == "yacht" else "Synthetic (no yacht file)"
        ax.set_title(f"{name} protocol reliability (pooled tau = {data['temperature_mean']:.2f})",
                     fontsize=10, color=INK)
        ax.legend(frameon=False, fontsize=8, loc="upper left")
        _style(ax)
        fig.tight_layout()
        return fig

    return _write(out_dir, "reliability", data, draw)


def fig_sampler_rescue(out_dir: str, study: str | None) -> dict:
    """The min ESS of each sampler on the over-trained posterior: the row
    of the study's mixed-lambda result that ran the tempering arm."""
    if study is None:
        return emit({"figure": "sampler_rescue", "data": None, "png": None,
                     "reason": "needs --study PATH, a run_vi_vs_hmc --out JSON of the port"})
    with open(study) as f:
        mixed = json.load(f)["mixed_lambda"]
    row = next(v for k, v in mixed.items() if k.startswith("epochs_") and "tempering" in v)
    sc = row["tempering"]["ess_scaling"]
    bars = [
        ["NUTS, identity mass", row["identity_mass"]["ess_min_overall"]],
        ["NUTS, adapted diagonal", row["adapted_mass"]["ess_min_overall"]],
        [f"PT {row['tempering']['n_rungs']}-rung, {sc['draws_quarter']} rounds", sc["ess_quarter"]],
        [f"PT {row['tempering']['n_rungs']}-rung, {sc['draws_full']} rounds", sc["ess_full"]],
    ]
    data = {"study": study, "epochs": row.get("epochs"), "ess": bars}

    def draw(plt):
        fig, ax = plt.subplots(figsize=(6.4, 3.2))
        for i, (label, ess) in enumerate(bars):
            color = BLUE if label.startswith("PT") else ORANGE
            ax.plot([0.8, ess], [i, i], color=color, linewidth=1.2, alpha=0.5, zorder=1)
            ax.plot([ess], [i], "o", color=color, markersize=8, zorder=2)
            ax.annotate(f"{ess:.0f}" if ess >= 10 else f"{ess:.1f}", (ess, i), xytext=(8, -3),
                        textcoords="offset points", fontsize=9, color=INK)
        ax.axvline(100, color=MUTED, linewidth=0.8, linestyle="--", zorder=0)
        ax.set_yticks(range(len(bars)))
        ax.set_yticklabels([b[0] for b in bars], fontsize=9)
        ax.set_xscale("log")
        ax.set_xlabel("min effective sample size (log scale)", fontsize=9, color=INK)
        ax.set_title("Over-trained mixed-λ posterior: tempering un-freezes the sampler",
                     fontsize=10, color=INK)
        _style(ax)
        ax.grid(axis="y", visible=False)
        fig.tight_layout()
        return fig

    return _write(out_dir, "sampler_rescue", data, draw)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", choices=FIGURES, default=None)
    ap.add_argument("--study", default=None, metavar="PATH",
                    help="a run_vi_vs_hmc --out JSON of the port (sampler_rescue)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    else:
        from whvi_tpu_torch.utils.profiling import require_cuda

        require_cuda()
        device = torch.device("cuda", 0)
    todo = FIGURES if args.only is None else (args.only,)
    out = []
    if "toy_fan" in todo:
        out.append(fig_toy_fan(args.out_dir, device, args.quick))
    if "crossover" in todo:
        out.append(fig_crossover(args.out_dir, device, args.quick))
    if "reliability" in todo:
        out.append(fig_reliability(args.out_dir, device, args.quick))
    if "sampler_rescue" in todo:
        out.append(fig_sampler_rescue(args.out_dir, args.study))
    return out


if __name__ == "__main__":
    main()
