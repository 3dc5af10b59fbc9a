"""Experiments of the port, each a module run as
``python -m whvi_tpu_torch.experiments.<name>`` on one card (each
``main`` refuses to run without one; each ``run`` takes its device):

- :mod:`~whvi_tpu_torch.experiments.run_scaling`: ELBO steps/s and
  predictive calls/s of a wide WHVI MLP against D on one card
  (``experiments/run_scaling.py``);
- :mod:`~whvi_tpu_torch.experiments.run_toy_cubic` and
  :mod:`~whvi_tpu_torch.experiments.run_toy_polynomial`: the reference's
  two toy regressions (``experiments/run_toy_cubic.py``,
  ``run_toy_polynomial.py``);
- :mod:`~whvi_tpu_torch.experiments.run_mnist`: the Bayesian classifier of
  BASELINE config 4 on MNIST's IDX files, scikit-learn's sets (``--cpu``)
  or synthetic data, with calibration and the NUTS check of its VI
  moments (``experiments/run_mnist.py``; ``--cpu`` asks for the CPU);
- :mod:`~whvi_tpu_torch.experiments.run_vi_vs_hmc`: VI against NUTS
  against the exact posterior, in three tiers
  (``experiments/run_vi_vs_hmc.py``; ``--cpu`` too);
- :mod:`~whvi_tpu_torch.experiments.run_baseline_configs`: BASELINE
  configs 3 (deep heteroscedastic) and 5 (large D) on data made from a
  seed (``experiments/run_baseline_configs.py``);
- :mod:`~whvi_tpu_torch.experiments.run_uci`: the UCI protocol (or a
  config grid) on one dataset (``experiments/run_uci.py``; ``--cpu`` asks
  for the CPU);
- :mod:`~whvi_tpu_torch.experiments.run_protocol_feasibility`: the whole
  protocol at kin8nm's shape on synthetic data, with its wall clock
  (``experiments/run_protocol_feasibility.py``; ``--cpu`` too);
- :mod:`~whvi_tpu_torch.experiments.make_toy_notebook`: writes the toy
  example notebook, its cells on the CPU unless ``--device cuda``
  (``experiments/make_toy_notebook.py``).
"""
